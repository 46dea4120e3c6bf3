"""Solve drivers: how the step function is iterated and how gradients flow.

The three drivers share the ``StepFunction`` ``init/step/finish`` interface
and differ only in the loop and the gradient strategy (the paper's Sec. 2.2 /
Table 5 axis):

``AutoDiffAdjoint``
    A Python loop while any instance is running and fewer than ``max_steps``
    iterations have run -- the JAX package's ``lax.while_loop``.  Reading
    ``running.any()`` for the loop condition synchronizes host and device once
    per step (ROADMAP A-16 removes that sync with CUDA graphs).  It is
    reverse-differentiable through torch autograd: on the CPU through the
    plain ops, on the card through the autograd Functions of the four
    explicit-path kernels (``kernels/autograd.py``).
``ScanAdjoint``
    Exactly ``max_steps`` steps, masked no-ops once an instance has stopped
    (the JAX package's bounded ``lax.scan``; discretize-then-optimize).  The
    loop reads nothing from the device.  ``checkpoint_every > 0`` wraps each
    block of that many steps, and the remainder block, in
    ``torch.utils.checkpoint`` (non-reentrant) over the flattened
    ``LoopState``, trading recompute for memory.
``BacksolveAdjoint``
    Optimize-then-discretize: the O(1)-memory adjoint-ODE backward pass of
    ``core/adjoint.py``.  Its forward and its backward are ordinary solves
    under no grad, so every kernel runs on the card in both directions.

On the card only the four explicit-path kernels have a backward: ``fused=True``,
``events=`` and the implicit steppers raise under autograd there (ROADMAP
A-18); on the CPU they differentiate through the plain ops.

All drivers accept structured initial states: ravel/unravel happens at the
term boundary (``terms.ravel_state`` / ``terms.ravel_term``), and the
returned ``Solution.ys`` (and ``event_y``) has the caller's structure again.
For structured states the vector field and the event conditions are
interpreted *per instance*.

``solve(..., device=None)`` runs on ``cuda`` unless the caller passes
``device="cpu"``; without a card and without ``device="cpu"`` it raises.
Inputs (numpy arrays, lists, tensors) are moved to that device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.utils.checkpoint import checkpoint

from .events import Event, normalize_events
from .solution import Solution
from .step import StepFunction, place_tolerance
from .stepper import AbstractStepper
from .terms import ODETerm, as_term, ravel_state, ravel_term


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card, and raises
    when there is none (there is no silent fallback to the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to solve on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def to_device(tree: Any, device: torch.device) -> Any:
    """Move every tensor and numpy array leaf of ``tree`` onto ``device``
    (dtypes kept); Python numbers and other leaves pass through."""
    def move(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        if isinstance(x, (np.ndarray, np.generic)):
            return torch.as_tensor(x, device=device)
        return x

    return pytree.tree_map(move, tree)


@dataclasses.dataclass(frozen=True, eq=False)
class _Driver:
    """Shared construction + structured-state plumbing for the loop drivers,
    as a frozen dataclass."""

    stepper: AbstractStepper | str | None = None
    controller: Any = None
    _: dataclasses.KW_ONLY
    rtol: Any = 1e-3
    atol: Any = 1e-6
    max_steps: int = 10_000
    dense: bool = True
    dense_window: int = 0
    batched_term: bool = True
    events: Any = None
    event_bisect_iters: int = 30
    extra_stats: tuple = ()
    fused: bool = False

    def __post_init__(self):
        object.__setattr__(self, "stepper", AbstractStepper.coerce(self.stepper))
        object.__setattr__(self, "events", normalize_events(self.events))
        object.__setattr__(self, "extra_stats", tuple(self.extra_stats))

    def _events_for(self, raveled) -> tuple[Event, ...]:
        """Events see the caller's state: for structured solves each
        per-instance condition receives the unravelled structure, not the
        flat buffer."""
        if raveled is None or not self.events:
            return self.events
        wrapped = []
        for e in self.events:
            if e.batched:
                raise ValueError(
                    "batched event conditions are not supported for PyTree "
                    "states; use per-instance cond_fn (batched=False)"
                )
            if e.with_args:
                cond = lambda t, y, args, _f=e.cond_fn: _f(t, raveled.unravel_one(y), args)
            else:
                cond = lambda t, y, _f=e.cond_fn: _f(t, raveled.unravel_one(y))
            wrapped.append(dataclasses.replace(e, cond_fn=cond))
        return tuple(wrapped)

    def _prepare(self, f, y0, device):
        """Normalize (f, y0) onto the flat convention on ``device``.  Returns
        ``(step_fn, y0_flat, raveled)``; ``raveled`` is None for flat input."""
        y0_flat, raveled = ravel_state(to_device(y0, device))
        y0_flat = y0_flat.to(device)
        if raveled is None:
            term = as_term(f, batched=self.batched_term)
        else:
            term = ravel_term(f, raveled)
        # Tolerance vectors go to the device once here, not once per step.
        step_fn = StepFunction(
            term,
            self.stepper,
            self.controller,
            rtol=place_tolerance(self.rtol, y0_flat),
            atol=place_tolerance(self.atol, y0_flat),
            dense=self.dense,
            dense_window=self.dense_window,
            events=self._events_for(raveled),
            event_bisect_iters=self.event_bisect_iters,
            extra_stats=self.extra_stats,
            fused=self.fused,
        )
        return step_fn, y0_flat, raveled

    @staticmethod
    def _finalize(sol: Solution, raveled) -> Solution:
        if raveled is None:
            return sol
        updates = dict(ys=raveled.unravel(sol.ys))
        if sol.event_y is not None:
            updates["event_y"] = raveled.unravel(sol.event_y)
        return dataclasses.replace(sol, **updates)


@dataclasses.dataclass(frozen=True, eq=False)
class AutoDiffAdjoint(_Driver):
    """The loop driver -- the paper's default forward solver.

    Example::

        solver = AutoDiffAdjoint(Stepper("tsit5"), pid_controller())
        sol = solver.solve(f, y0, t_eval, args=args)
    """

    def solve(
        self,
        f,
        y0,
        t_eval=None,
        *,
        t_start=None,
        t_end=None,
        dt0=None,
        args: Any = None,
        device=None,
    ) -> Solution:
        device = resolve_device(device)
        step_fn, y0_flat, raveled = self._prepare(f, y0, device)
        args = to_device(args, device)
        state, consts = step_fn.init(y0_flat, t_eval, t_start, t_end, dt0, args)
        it = 0
        # The loop never runs a step once every instance has stopped, so
        # state and stats stay as they were (the JAX step's `inc` guard).
        while it < self.max_steps and bool(state.running.any()):
            state = step_fn.step(state, consts, args)
            it += 1
        return self._finalize(step_fn.finish(state, consts), raveled)


@dataclasses.dataclass(frozen=True, eq=False)
class ScanAdjoint(_Driver):
    """Bounded-loop driver: reverse-mode differentiable
    (discretize-then-optimize), with optional checkpointed blocks.

    Runs exactly ``max_steps`` steps; an instance that has stopped keeps
    being evaluated but its state is frozen by the step's masks, as in the
    JAX package's ``lax.scan``, so step counts and statistics equal JAX's.
    """

    _: dataclasses.KW_ONLY
    max_steps: int = 256
    checkpoint_every: int = 0

    def solve(
        self,
        f,
        y0,
        t_eval=None,
        *,
        t_start=None,
        t_end=None,
        dt0=None,
        args: Any = None,
        device=None,
    ) -> Solution:
        device = resolve_device(device)
        step_fn, y0_flat, raveled = self._prepare(f, y0, device)
        args = to_device(args, device)
        state, consts = step_fn.init(y0_flat, t_eval, t_start, t_end, dt0, args)

        def run(s, n):
            for _ in range(n):
                s = step_fn.step(s, consts, args)
            return s

        every = self.checkpoint_every
        if every and every > 0:
            blocks, rem = divmod(self.max_steps, every)
            # The remainder block is checkpointed too: left outside, its
            # steps' activations would be kept for the backward pass.
            for n in [every] * blocks + ([rem] if rem else []):
                state = _checkpointed(run, state, n)
        else:
            state = run(state, self.max_steps)
        return self._finalize(step_fn.finish(state, consts), raveled)


def _checkpointed(run, state, n):
    """``run(state, n)`` under non-reentrant ``torch.utils.checkpoint`` over
    the flattened state: the block's saved tensors are dropped after its
    forward and recomputed from its input state in the backward pass."""
    leaves, spec = pytree.tree_flatten(state)

    def block(*leaves):
        return tuple(pytree.tree_leaves(run(pytree.tree_unflatten(list(leaves), spec), n)))

    return pytree.tree_unflatten(list(checkpoint(block, *leaves, use_reentrant=False)), spec)


def _tree_key(y0):
    """A structured state's structure: its tree spec and every leaf's shape
    and dtype (the unravel closure is structure-specific, so the backsolve
    memo is too)."""
    leaves, spec = pytree.tree_flatten(y0)
    return repr(spec), tuple((tuple(np.shape(x)), str(getattr(x, "dtype", type(x))))
                             for x in leaves)


@dataclasses.dataclass(frozen=True, eq=False)
class BacksolveAdjoint:
    """Adjoint-equation driver (optimize-then-discretize, O(1) memory in
    solver steps).

    Tracks only the final state; its backward solves the augmented adjoint
    ODE backwards in time through ``core/adjoint.py``'s autograd Function.
    Both solves are ordinary solves under no grad, so on the card they run
    through the kernels with no backward of their own; the vector field is
    differentiated by ``torch.func.vjp``.

    **Return contract:** ``solve`` returns the final state ``y(t_end)`` -- a
    tensor of ``y0``'s shape for flat input, the caller's structure
    otherwise -- not a ``Solution``.

    **Memoization:** the ``make_adjoint_solve`` closure is memoized per
    (vector-field identity, state structure) on the driver instance, so
    repeated ``solve`` calls with the same term reuse one closure.

    ``ODETerm.batched_args`` terms thread each instance's own parameter row
    through the backward pass (per-request rows stay per-request in the
    returned cotangent).
    """

    stepper: AbstractStepper | str | None = None
    controller: Any = None
    _: dataclasses.KW_ONLY
    rtol: Any = 1e-3
    atol: Any = 1e-6
    max_steps: int = 10_000
    mode: str = "joint"
    events: Any = None
    _solve_memo: dict = dataclasses.field(init=False, repr=False, default=None)

    def __post_init__(self):
        if normalize_events(self.events):
            # Gradients through an event time need the implicit function
            # theorem on the adjoint boundary condition, which the backsolve
            # does not implement.  Refuse rather than ignore the events.
            raise ValueError(
                "BacksolveAdjoint does not support events: its O(1)-memory "
                "custom_vjp integrates the adjoint ODE from a fixed t_end and "
                "cannot differentiate through per-instance stopping times. "
                "Use AutoDiffAdjoint (forward mode) or ScanAdjoint "
                "(discretize-then-optimize) for event-terminated solves."
            )
        object.__setattr__(self, "stepper", AbstractStepper.coerce(self.stepper))
        object.__setattr__(self, "events", ())
        object.__setattr__(self, "_solve_memo", {})

    def _adjoint_solve(self, f, state_key, raveled):
        """The memoized ``make_adjoint_solve`` closure for ``(f, state
        structure)``."""
        from .adjoint import make_adjoint_solve  # deferred: adjoint imports loop

        fkey = f if isinstance(f, ODETerm) else (type(f), id(f))
        key = (fkey, state_key)
        solve_fn = self._solve_memo.get(key)
        if solve_fn is None:
            if raveled is None:
                flat_f = f.vf if isinstance(f, ODETerm) else f
            else:
                flat_f = ravel_term(f, raveled).vf
            solve_fn = make_adjoint_solve(
                flat_f,
                method=self.stepper,
                rtol=self.rtol,
                atol=self.atol,
                max_steps=self.max_steps,
                mode=self.mode,
                controller=self.controller,
                batched_args=isinstance(f, ODETerm) and f.batched_args,
            )
            self._solve_memo[key] = solve_fn
        return solve_fn

    def solve(self, f, y0, *, t_start, t_end, args: Any = None, device=None):
        device = resolve_device(device)
        y0_flat, raveled = ravel_state(to_device(y0, device))
        # None for flat states; the structure otherwise.
        state_key = None if raveled is None else _tree_key(y0)
        solve_fn = self._adjoint_solve(f, state_key, raveled)
        ys = solve_fn(y0_flat.to(device), t_start, t_end, to_device(args, device),
                      device=device)
        return raveled.unravel(ys) if raveled is not None else ys
