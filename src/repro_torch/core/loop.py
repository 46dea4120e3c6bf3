"""One-call wrappers over the componentized solver core.

``solve_ivp``, ``solve_ivp_scan`` and ``make_solver`` keep the JAX package's
signatures, plus the explicit ``device`` of the two solves.  New code may compose the components
directly::

    solver = AutoDiffAdjoint(Stepper("tsit5"), pid_controller())
    sol = solver.solve(f, y0, t_eval, args=args)
"""

from __future__ import annotations

import warnings
from typing import Any

from .drivers import AutoDiffAdjoint, ScanAdjoint
from .solution import Solution
from .step import StepFunction
from .stepper import AbstractStepper
from .terms import as_term


def make_solver(
    f,
    *,
    method: str = "dopri5",
    rtol=1e-3,
    atol=1e-6,
    controller=None,
    max_steps: int = 10_000,
    batched_term: bool = True,
    dense: bool = True,
    dense_window: int = 0,
    events=None,
    event_bisect_iters: int = 30,
    fused: bool = False,
):
    """Build (init_fn, body_fn, finish_fn) for a caller-owned loop.

    ``max_steps`` is accepted for signature stability only: the *caller*
    owns the loop, so a non-default value warns instead of being silently
    ignored.  The caller places ``y0`` (and tolerance vectors) on the device.

    On the card ``step`` writes the dense output into the ``ys`` of the state
    it is given, and the recorded event states into its ``estate.y``, and
    returns those buffers in the new state (see ``StepFunction``): clone
    them before the call to keep an old state intact.  On the CPU the old
    state is left as it was.
    """
    if max_steps != 10_000:
        warnings.warn(
            "make_solver ignores max_steps: it returns (init, step, finish) and "
            "the iteration bound belongs to the caller's loop. Bound your own "
            "loop, or use solve_ivp / AutoDiffAdjoint(max_steps=...) which own "
            "their loop.",
            UserWarning,
            stacklevel=2,
        )
    del max_steps
    step_fn = StepFunction(
        as_term(f, batched=batched_term),
        AbstractStepper.coerce(method),
        controller,
        rtol=rtol,
        atol=atol,
        dense=dense,
        dense_window=dense_window,
        events=events,
        event_bisect_iters=event_bisect_iters,
        fused=fused,
    )
    return step_fn.init, step_fn.step, step_fn.finish


def solve_ivp(
    f,
    y0,
    t_eval=None,
    *,
    t_start=None,
    t_end=None,
    method: str = "dopri5",
    rtol=1e-3,
    atol=1e-6,
    controller=None,
    dt0=None,
    max_steps: int = 10_000,
    args: Any = None,
    batched_term: bool = True,
    dense: bool = True,
    dense_window: int = 0,
    events=None,
    event_bisect_iters: int = 30,
    fused: bool = False,
    device=None,
) -> Solution:
    """Solve a batch of IVPs in parallel with independent per-instance state.

    y0:     (batch, features) initial conditions, or any structure (dicts,
            lists, tuples) whose tensor leaves carry the batch as their
            leading axis (ravelled at the term boundary; the vector field then
            receives per-instance structures)
    t_eval: (n,) shared or (batch, n) per-instance evaluation points, or None to
            track only the final state
    t_start/t_end: scalars or (batch,) vectors; default to t_eval boundaries.
            Integration ranges may differ per instance, including direction.
    method: a tableau name: explicit ("dopri5", "tsit5", "bosh3", "heun",
            "euler", "midpoint", "rk4") or diagonally implicit for stiff
            problems ("kvaerno5", "kvaerno3", "trbdf2", "implicit_euler",
            solved by ``DiagonallyImplicitRK`` with the batched chord-Newton
            layer), or a stepper instance.
    rtol/atol: scalars shared by the batch, per-instance (b,) or full (b, f).
    fused:  run each step attempt through the fused step kernel: one
            ``fused_step`` launch after the stage sweep, or for a
            ``polynomial_term`` one ``fused_step_poly`` launch and no vf
            launch.  Under ``DiagonallyImplicitRK`` the chord matrix is
            factored once per step attempt (``batched_lu_factor``) and each
            Newton iteration is one ``fused_newton_iter`` launch before the
            ``fused_step`` launch.  Engages for exactly ``ExplicitRK`` or
            ``DiagonallyImplicitRK`` with exactly ``PIDController`` or
            ``FixedController``; otherwise the unfused path runs and
            ``stats["fused_fallback_reason"]`` says why.  Same results as
            unfused (bitwise on the CPU).
    events: an ``Event`` (or sequence of them) with per-instance scalar
            conditions ``cond_fn(t, y, args)``; terminal events stop each
            instance independently at its own localized event time
            (``Status.EVENT``).  The solution then carries per-instance
            ``event_t`` / ``event_y`` / ``event_mask``.  Localization bisects
            the step's dense-output interpolant ``event_bisect_iters`` times
            (zero extra vector-field evaluations), on both paths (``fused``
            or not).
    device: where to solve.  ``None`` means the CUDA device, and raises when
            there is none; pass ``device="cpu"`` to solve on the CPU with the
            plain ops.  Inputs are moved to this device.

    Returns a ``Solution`` with per-instance status and statistics.
    """
    driver = AutoDiffAdjoint(
        AbstractStepper.coerce(method),
        controller,
        rtol=rtol,
        atol=atol,
        max_steps=max_steps,
        dense=dense,
        dense_window=dense_window,
        batched_term=batched_term,
        events=events,
        event_bisect_iters=event_bisect_iters,
        fused=fused,
    )
    return driver.solve(f, y0, t_eval, t_start=t_start, t_end=t_end, dt0=dt0, args=args,
                        device=device)


def solve_ivp_scan(
    f,
    y0,
    t_eval=None,
    *,
    t_start=None,
    t_end=None,
    method: str = "dopri5",
    rtol=1e-3,
    atol=1e-6,
    controller=None,
    dt0=None,
    max_steps: int = 256,
    args: Any = None,
    batched_term: bool = True,
    dense: bool = True,
    dense_window: int = 0,
    checkpoint_every: int = 0,
    events=None,
    event_bisect_iters: int = 30,
    fused: bool = False,
    device=None,
) -> Solution:
    """Reverse-mode-differentiable variant (``ScanAdjoint``): exactly
    ``max_steps`` iterations with masked no-op steps after termination
    (discretize-then-optimize), no host read inside the loop.
    ``checkpoint_every`` > 0 wraps blocks of steps in ``torch.utils.checkpoint``
    to trade recompute for memory on long solves.  Differentiate with
    ``torch.autograd`` (``loss.backward()``); on the card every path does
    (unfused, ``fused``, ``events`` and the implicit methods), through the
    kernels' autograd Functions.  ``device`` as in ``solve_ivp``.
    """
    driver = ScanAdjoint(
        AbstractStepper.coerce(method),
        controller,
        rtol=rtol,
        atol=atol,
        max_steps=max_steps,
        dense=dense,
        dense_window=dense_window,
        batched_term=batched_term,
        checkpoint_every=checkpoint_every,
        events=events,
        event_bisect_iters=event_bisect_iters,
        fused=fused,
    )
    return driver.solve(f, y0, t_eval, t_start=t_start, t_end=t_end, dt0=dt0, args=args,
                        device=device)
