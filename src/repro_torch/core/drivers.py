"""Solve drivers: how the step function is iterated.

``AutoDiffAdjoint`` iterates ``StepFunction.step`` in a Python loop while any
instance is running and fewer than ``max_steps`` iterations have run -- the
JAX package's ``lax.while_loop``.  Reading ``running.any()`` for the loop
condition synchronizes host and device once per step (ROADMAP A-16 removes
that sync with CUDA graphs).  On the CPU the loop is differentiable through
torch autograd; the CUDA kernels have no backward yet (ROADMAP A-11).

``fused=True`` runs each step attempt through the fused step kernel (see
``StepFunction``).  Explicit and diagonally implicit steppers both run on
either path; the implicit stepper's cross-step carry (its chord Jacobian)
rides in ``LoopState.scarry``.  ``ScanAdjoint`` and ``BacksolveAdjoint`` keep
their names and refuse to construct until gradients are ported (ROADMAP
A-11).

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

from .events import Event, normalize_events
from .solution import Solution
from .step import StepFunction, place_tolerance
from .stepper import AbstractStepper
from .terms import as_term, ravel_state, ravel_term


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


class ScanAdjoint:
    """Bounded-loop, reverse-differentiable driver: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("ScanAdjoint is not ported yet (ROADMAP A-11)")


class BacksolveAdjoint:
    """Adjoint-equation driver (O(1) memory): not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("BacksolveAdjoint is not ported yet (ROADMAP A-11)")
