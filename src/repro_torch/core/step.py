"""The shared ``init/step/finish`` step function of the batch-parallel solver.

``StepFunction`` composes the three swappable components -- ``ODETerm``
(dynamics), a stepper (``ExplicitRK`` or ``DiagonallyImplicitRK``: tableau +
stage recursion + interpolant, plus a cross-step carry in
``LoopState.scarry``, the implicit stepper's reused Jacobian and its
per-instance refresh mask) and a controller -- into one adaptive solver step
for the whole batch.  ``AutoDiffAdjoint`` in ``drivers.py`` iterates it; ``make_solver`` in
``loop.py`` exposes the bare function triple for callers that build their own
loop.

Every instance in the batch carries its own time, step size, controller
history, accept/reject decision, termination status and (when events are
registered) event bookkeeping: sign changes of each event condition are
detected on accepted steps and localized by masked bisection on the step's
dense-output interpolant (``core/events.py``), and a fired terminal event
stops that instance at the interpolated event state with ``Status.EVENT``.
Instances that finish early keep being *evaluated* (the dynamics run on the
full batch -- torchode's "overhanging evaluations") but their state is frozen
by masking, so results are unaffected.  An explicit step without events never
synchronizes host and device; the solve loop's condition does, once per
step.  With events the step reads which events fired anywhere in the batch
(one more sync per step, ``events.advance``).  An implicit step reads whether
any row asks for a Jacobian refresh (once per step) and whether any row is
still iterating (once per Newton iteration, ``core/newton.py``).  A failed
Newton solve is a controller reject, never a commit.

Statistics registry
-------------------
``LoopState.stats`` is a dict of named per-instance ``(b,)`` accumulators.
Each component contributes entries via an ``init_stats(batch) -> dict`` hook
and advances them in ``update_stats(stats, ctx) -> dict``, where ``ctx`` is a
``StepContext`` describing the step just taken.  The stepper records
``n_f_evals``, the controller ``n_accepted``, the step function itself
``n_steps``, ``n_initialized`` and, when events are registered,
``n_events``; the implicit stepper also records ``n_newton_iters`` and
``n_jac_evals``; user code can register additional
contributors through ``extra_stats``.  With ``fused=True`` the step function
also records ``fused_fallback_reason`` (whether the fused path engaged, and if
not why) and, when it engaged, ``n_fused_steps``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, NamedTuple

import torch

from ..kernels import ops
from .controller import (
    ControllerState,
    FixedController,
    PIDController,
    _ControllerStats,
    integral_controller,
)
from .events import advance as advance_events
from .events import init_event_state, normalize_events
from .solution import Solution, Status
from .stepper import AbstractStepper, DiagonallyImplicitRK, ExplicitRK, _tableau_arrays
from .terms import ODETerm, PolynomialTerm, as_term


class FusedFallbackReason(enum.IntEnum):
    """Why the ``fused=True`` fast path did or did not engage.

    Recorded per instance in ``Solution.stats["fused_fallback_reason"]``
    whenever ``fused=True`` was requested (ENGAGED means it ran).  The codes
    are static properties of the configuration: every instance in a batch
    carries the same value.
    """

    ENGAGED = 0
    # The stepper is not exactly ExplicitRK or DiagonallyImplicitRK: a
    # subclass may override the stage recursion the fused path bakes in.
    NOT_EXPLICIT_RK = 1
    # The controller is not exactly PIDController or FixedController: the
    # kernel bakes in those two accept/next-dt programs only, and a subclass
    # may override ``__call__``.
    UNSUPPORTED_CONTROLLER = 2
    # The stepper is a DiagonallyImplicitRK SUBCLASS: the fused implicit
    # path bakes in the exact factor-once chord-Newton stage sweep, which a
    # subclass may override.
    UNSUPPORTED_IMPLICIT = 3


class LoopState(NamedTuple):
    t: torch.Tensor  # (b,) current time
    dt: torch.Tensor  # (b,) signed step proposal for the next attempt
    y: torch.Tensor  # (b, f)
    f0: torch.Tensor  # (b, f) FSAL derivative cache at (t, y)
    scarry: Any  # stepper cross-step carry (() for explicit, DIRKCarry for DIRK)
    cstate: ControllerState
    running: torch.Tensor  # (b,) bool
    status: torch.Tensor  # (b,) int32
    stats: dict[str, torch.Tensor]  # named (b,) accumulators (statistics registry)
    ys: torch.Tensor  # (b, n, f) dense output buffer (or (b, 0, f) when unused)
    it: torch.Tensor  # () int32 global iteration counter
    estate: Any = ()  # per-instance event bookkeeping (EventState, or () without events)


class StepContext(NamedTuple):
    """What a statistics contributor may observe about the step just taken."""

    running: torch.Tensor  # (b,) bool: running mask *before* this step
    accept: torch.Tensor  # (b,) bool: accepted this step (masked by running)
    step_active: torch.Tensor  # () int32: 1 while any instance runs (overhanging evals)
    n_f_evals: Any  # dynamics-evaluation count of this step (int)
    n_written: torch.Tensor  # (b,) int32: dense-output points written this step
    err_ratio: torch.Tensor  # (b,) weighted RMS error ratio of this step
    aux: dict | None = None  # stepper-private extras (e.g. Newton iteration counts)
    n_events: torch.Tensor | None = None  # (b,) int32: events recorded this step


def place_tolerance(tol, like: torch.Tensor):
    """A tolerance as the kernels take it: a Python number stays a number
    (passed by value), anything else becomes a tensor in ``like``'s dtype on
    its device (a no-op for a tensor already placed there)."""
    if isinstance(tol, (int, float)):
        return float(tol)
    return torch.as_tensor(tol, dtype=like.dtype, device=like.device)


def _normalize_times(y0, t_eval, t_start, t_end, dtype):
    b, device = y0.shape[0], y0.device
    if t_eval is not None:
        t_eval = torch.as_tensor(t_eval, dtype=dtype, device=device)
        if t_eval.ndim == 1:
            t_eval = t_eval[None, :].expand(b, t_eval.shape[0]).contiguous()
        if t_start is None:
            t_start = t_eval[:, 0]
        if t_end is None:
            t_end = t_eval[:, -1]
    if t_start is None or t_end is None:
        raise ValueError("need t_eval or (t_start, t_end)")
    t_start = torch.as_tensor(t_start, dtype=dtype, device=device).expand(b).contiguous()
    t_end = torch.as_tensor(t_end, dtype=dtype, device=device).expand(b).contiguous()
    return t_eval, t_start, t_end


@dataclasses.dataclass(frozen=True, eq=False)
class StepFunction:
    """One adaptive solver step for the whole batch, on flat (b, f) tensors.

    Structured states are ravelled *before* they reach this class (see
    ``terms.ravel_state`` / the drivers).  A ``StepFunction`` is a frozen
    dataclass; ``init``/``step``/``finish`` keep no mutable Python-object
    state in the hot path.

    In-place dense output: ``step`` hands ``state.ys`` to ``ops.interp_eval``,
    which on a CUDA tensor writes the eval points this step passed straight
    into that buffer (saving a full (b, n, f) rewrite per step) and returns
    it.  So on the card the ``ys`` of the state passed to ``step`` is consumed:
    after the call it holds the new state's dense output, and a caller that
    keeps the old state (to retry a step, or compare two states) must clone
    ``ys`` first.  On the CPU ``step`` returns a new buffer and leaves the old
    state's ``ys`` as it was.

    ``fused=True`` asks for the fused fast path: after the stage sweep one
    ``ops.fused_step`` launch per step attempt does the combine, the error
    norm, the controller decision, the masked commit and the Hermite
    coefficients; for a ``PolynomialTerm`` under an explicit stepper one
    ``ops.fused_step_poly`` launch does the whole attempt, stages included.
    Under exactly ``DiagonallyImplicitRK`` the stage sweep factors the chord
    matrix once per attempt (``batched_lu_factor``) and runs each Newton
    iteration as one ``fused_newton_iter``, and ``fused_step`` takes the
    Newton failures as its ``failed`` input.  It engages for exactly
    ``ExplicitRK`` or ``DiagonallyImplicitRK`` driven by exactly
    ``PIDController`` or ``FixedController``; anything else solves through
    the unfused path and says why in ``stats["fused_fallback_reason"]``.

    ``events``: an ``Event`` or a sequence of them (normalized to a tuple),
    detected on every accepted step and localized by ``event_bisect_iters``
    bisection steps on the step's dense-output interpolant; the Hermite
    coefficients are then built on every step, dense output or not.  On the
    card the event record ``estate.y`` is updated in place like ``ys``.
    """

    term: ODETerm
    stepper: AbstractStepper | str | None = None
    controller: Any = None
    _: dataclasses.KW_ONLY
    rtol: Any = 1e-3
    atol: Any = 1e-6
    dense: bool = True
    dense_window: int = 0
    events: Any = None
    event_bisect_iters: int = 30
    extra_stats: tuple = ()
    fused: bool = False
    stat_contributors: tuple = dataclasses.field(init=False, repr=False)
    # Derived from the configuration: the fused kernel's controller program
    # ("pid", "fixed", or None when the fused path is off), the
    # FusedFallbackReason code, and whether the fused path is the implicit one.
    fused_mode: str | None = dataclasses.field(init=False, repr=False)
    fused_fallback: int = dataclasses.field(init=False, repr=False)
    fused_implicit: bool = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        stepper = AbstractStepper.coerce(self.stepper)
        controller = self.controller
        if controller is None:
            controller = integral_controller() if stepper.is_adaptive else FixedController()
        extra_stats = tuple(self.extra_stats)
        # Exact-type checks, not isinstance: a subclass may override the
        # stage recursion or ``__call__`` with a program the kernel does not
        # bake in.  Everything else falls back to the unfused path, with the
        # same results.
        mode, why = None, FusedFallbackReason.ENGAGED
        implicit = type(stepper) is DiagonallyImplicitRK
        if type(stepper) is not ExplicitRK and not implicit:
            why = (FusedFallbackReason.UNSUPPORTED_IMPLICIT
                   if isinstance(stepper, DiagonallyImplicitRK)
                   else FusedFallbackReason.NOT_EXPLICIT_RK)
        elif type(controller) is PIDController:
            mode = "pid"
        elif type(controller) is FixedController:
            mode = "fixed"
        else:
            why = FusedFallbackReason.UNSUPPORTED_CONTROLLER
        # Registry order: component contributions first, loop bookkeeping last.
        # Duck-typed controllers without the registry hooks still get
        # n_accepted recorded.
        controller_stats = controller if hasattr(controller, "init_stats") else _ControllerStats()
        for name, value in (
            ("term", as_term(self.term)),
            ("events", normalize_events(self.events)),
            ("stepper", stepper),
            ("controller", controller),
            ("extra_stats", extra_stats),
            ("stat_contributors", (stepper, controller_stats, self, *extra_stats)),
            ("fused", bool(self.fused)),
            ("fused_mode", mode if self.fused else None),
            ("fused_fallback", int(why)),
            ("fused_implicit", bool(self.fused and mode is not None and implicit)),
        ):
            object.__setattr__(self, name, value)

    # --- the step function's own statistics contribution ---
    def init_stats(self, batch: int) -> dict[str, torch.Tensor]:
        zeros = torch.zeros((batch,), dtype=torch.int32)
        out = {"n_steps": zeros, "n_initialized": zeros.clone()}
        if self.events:
            out["n_events"] = zeros.clone()
        if self.fused:
            out["fused_fallback_reason"] = torch.full(
                (batch,), self.fused_fallback, dtype=torch.int32
            )
        if self.fused_mode is not None:
            # Steps taken through the fused kernel; equals n_steps while the
            # fast path is engaged.
            out["n_fused_steps"] = zeros.clone()
        return out

    def update_stats(self, stats: dict, ctx: StepContext) -> dict:
        out = {
            **stats,
            "n_steps": stats["n_steps"] + ctx.step_active * ctx.running.to(torch.int32),
            "n_initialized": stats["n_initialized"] + ctx.n_written,
        }
        if ctx.n_events is not None:
            out["n_events"] = stats["n_events"] + ctx.n_events
        return out

    def _collect_init_stats(self, batch: int, device) -> dict[str, torch.Tensor]:
        stats: dict[str, torch.Tensor] = {}
        for c in self.stat_contributors:
            hook = getattr(c, "init_stats", None)
            if hook is not None:
                for name, acc in hook(batch).items():
                    if name in stats:
                        raise ValueError(f"duplicate statistic {name!r} in registry")
                    stats[name] = acc.to(device)
        return stats

    def _apply_stat_updates(self, stats: dict, ctx: StepContext) -> dict:
        for c in self.stat_contributors:
            hook = getattr(c, "update_stats", None)
            if hook is not None:
                stats = hook(stats, ctx)
        return stats

    def _tolerances(self, y: torch.Tensor):
        return place_tolerance(self.atol, y), place_tolerance(self.rtol, y)

    def _scale(self, y: torch.Tensor) -> torch.Tensor:
        """The (b, f) error scale atol + rtol*|y| of the Newton convergence
        test.  Tolerances may be scalars, per-instance (b,) vectors or full
        (b, f) tensors."""
        atol, rtol = ops.broadcast_tolerances(self.atol, self.rtol, y.dtype, y.device)
        return atol + rtol * torch.abs(y)

    def init(self, y0, t_eval=None, t_start=None, t_end=None, dt0=None, args=None):
        """Build the initial LoopState.  Returns ``(state, consts)`` where
        ``consts = (t_eval, t_start, t_end, direction)`` is loop-invariant."""
        y0 = torch.as_tensor(y0)
        dtype, device = y0.dtype, y0.device
        b, feat = y0.shape
        t_eval, t_start, t_end = _normalize_times(y0, t_eval, t_start, t_end, dtype)
        direction = torch.sign(t_end - t_start)
        direction = torch.where(direction == 0, torch.ones_like(direction), direction)

        f0 = self.stepper.init(self.term, t_start, y0, args)
        if dt0 is None:
            # The proposal is clamped to the controller's step bounds.
            atol, rtol = self._tolerances(y0)
            dt = self.stepper.initial_step_size(
                self.term, t_start, y0, f0, direction, atol, rtol, args,
                dt_min=getattr(self.controller, "dt_min", 0.0),
                dt_max=getattr(self.controller, "dt_max", float("inf")),
            )
            n_init_evals = 2
        else:
            dt0 = torch.as_tensor(dt0, dtype=dtype, device=device).expand(b)
            dt = dt0 * direction
            n_init_evals = 1

        if self.dense and t_eval is not None:
            n = t_eval.shape[1]
            ys = torch.zeros((b, n, feat), dtype=dtype, device=device)
            # Pre-write all evaluation points at/before t_start (usually just the
            # first one) with the initial condition.
            pre = direction[:, None] * (t_eval - t_start[:, None]) <= 0.0
            ys = torch.where(pre[:, :, None], y0[:, None, :], ys)
            n_initialized = pre.sum(dim=1).to(torch.int32)
        else:
            ys = torch.zeros((b, 0, feat), dtype=dtype, device=device)
            n_initialized = torch.zeros((b,), dtype=torch.int32, device=device)

        stats = self._collect_init_stats(b, device)
        stats["n_f_evals"] = stats["n_f_evals"] + n_init_evals
        stats["n_initialized"] = stats["n_initialized"] + n_initialized

        state = LoopState(
            t=t_start,
            dt=dt,
            y=y0,
            f0=f0,
            scarry=self.stepper.init_carry(self.term, t_start, y0, f0, args),
            cstate=self.controller.init(b, dtype, device),
            running=torch.ones((b,), dtype=torch.bool, device=device),
            status=torch.zeros((b,), dtype=torch.int32, device=device),
            stats=stats,
            ys=ys,
            it=torch.zeros((), dtype=torch.int32, device=device),
            estate=(
                init_event_state(self.events, t_start, y0, args) if self.events else ()
            ),
        )
        return state, (t_eval, t_start, t_end, direction)

    def _propose(self, state: LoopState, consts):
        """The per-instance step proposal.  Returns ``(dt_prop, cursor, t_win,
        W)``; the last three are ``(None, None, 0)`` unless windowed dense
        output is active.

        Windowed dense output: only a window of W eval points at the
        per-instance cursor is touched per step, instead of masking over ALL
        n points.  The attempt is clamped so a step never crosses beyond the
        window's last point."""
        t_eval, t_start, t_end, direction = consts
        if not (self.dense and t_eval is not None and self.dense_window > 0):
            return state.dt, None, None, 0
        n_pts = t_eval.shape[1]
        W = min(self.dense_window, n_pts)
        n_init = state.stats["n_initialized"]
        cursor = torch.clamp(n_init, max=n_pts - W).to(torch.int64)  # (b,)
        t_win = torch.gather(
            t_eval, 1, cursor[:, None] + torch.arange(W, device=cursor.device)
        )
        has_beyond = (n_init + W) < n_pts
        lim = torch.where(has_beyond, t_win[:, -1] - state.t, t_end - state.t)
        clamp = has_beyond & (direction * lim > 0) & (torch.abs(lim) < torch.abs(state.dt))
        return torch.where(clamp, lim, state.dt), cursor, t_win, W

    def _write_dense(self, state, consts, coeffs, accept, t_stop, safe_dt, cursor, t_win, W):
        """Write every eval point passed by this step into the dense-output
        buffer (windowed or full-mask).  Returns ``(ys, n_written)``; on the
        card ``ys`` is updated in place."""
        t_eval, t_start, t_end, direction = consts
        ys = state.ys
        n_written = torch.zeros_like(state.running, dtype=torch.int32)
        if t_win is not None:
            xw = torch.clamp((t_win - state.t[:, None]) / safe_dt[:, None], 0.0, 1.0)
            after_t = direction[:, None] * (t_win - state.t[:, None]) > 0.0
            upto_new = direction[:, None] * (t_win - t_stop[:, None]) <= 0.0
            maskw = accept[:, None] & after_t & upto_new
            ys = ops.interp_eval(coeffs, xw, maskw, ys, cursor)
            n_written = maskw.sum(dim=1).to(torch.int32)
        elif self.dense and t_eval is not None:
            x = (t_eval - state.t[:, None]) / safe_dt[:, None]
            x = torch.clamp(x, 0.0, 1.0)  # masked points stay finite
            after_t = direction[:, None] * (t_eval - state.t[:, None]) > 0.0
            upto_new = direction[:, None] * (t_eval - t_stop[:, None]) <= 0.0
            mask = accept[:, None] & after_t & upto_new
            ys = ops.interp_eval(coeffs, x, mask, ys)
            n_written = mask.sum(dim=1).to(torch.int32)
        return ys, n_written

    def _attempt(self, state: LoopState, consts):
        """The step attempt of every instance, clamped so the final step lands
        exactly on t_end.  Returns ``(will_finish, safe_dt, t_new, window)``:
        ``safe_dt`` is the signed step the stages use, ``t_new`` the time
        reached if accepted, ``window`` the ``(cursor, t_win, W)`` of
        ``_propose``."""
        t_end = consts[2]
        finfo = torch.finfo(state.y.dtype)
        dt_prop, *window = self._propose(state, consts)
        rem = t_end - state.t
        will_finish = torch.abs(dt_prop) >= torch.abs(rem)
        dt_used = torch.where(will_finish, rem, dt_prop)
        safe_dt = torch.where(torch.abs(dt_used) > finfo.tiny, dt_used, 1.0)
        t_new = torch.where(will_finish, t_end, state.t + dt_used)
        return will_finish, safe_dt, t_new, window

    def _advance(self, state: LoopState, consts, committed: LoopState, args, *, y1, accept,
                 will_finish, t_new, safe_dt, window, coeffs, n_f_evals, err_ratio,
                 aux=None):
        """The new loop state, from the masked commit of ``(t, dt, y, f0,
        cstate)`` in ``committed``: detect, localize and record this step's
        events, stop instances that finished, whose step collapsed or whose
        terminal event fired, write the dense output (truncated at the
        event), advance the statistics."""
        t_eval, t_start, t_end, direction = consts
        finfo = torch.finfo(state.y.dtype)
        any_running = state.running.any()
        done_now = accept & will_finish
        # step-size floor: instances whose step collapses are stopped (where
        # ``running`` holds, the committed dt is the controller's dt_next)
        dt_floor = 8.0 * finfo.eps * torch.maximum(torch.abs(state.t), torch.abs(t_end))
        nonfinite_y = ~torch.all(torch.isfinite(y1), dim=-1)
        stopped = state.running & ~accept & (torch.abs(committed.dt) <= dt_floor)

        # --- events: detect sign changes on accepted steps, localize by
        # masked bisection on the interpolant (zero extra vf evaluations),
        # stop instances whose terminal event fired ---
        if self.events:
            adv = advance_events(
                self.events, state.estate, coeffs, state.t, safe_dt, t_new,
                y1, accept, args, self.event_bisect_iters,
            )
            # Dense output and the committed state are truncated at the
            # earliest terminal event time.
            t_stop = torch.where(adv.stop, adv.t_stop, t_new)
        else:
            adv, t_stop = None, t_new

        # --- dense output: write every eval point passed by this step ---
        ys, n_written = self._write_dense(state, consts, coeffs, accept, t_stop, safe_dt,
                                          *window)

        running = state.running & ~done_now & ~stopped
        status = torch.where(
            done_now,
            Status.SUCCESS.value,
            torch.where(
                stopped,
                torch.where(nonfinite_y, Status.INFINITE.value, Status.REACHED_DT_MIN.value),
                state.status,
            ),
        )
        if adv is not None:
            # An event-stopped instance rests AT the event: its committed
            # state is the interpolated (event_t, event_y), not (t_new, y1).
            # EVENT takes precedence over SUCCESS on the final step.
            committed = committed._replace(
                y=torch.where(adv.stop[:, None], adv.y_stop, committed.y),
                t=torch.where(adv.stop, t_stop, committed.t),
                estate=adv.estate,
            )
            running = running & ~adv.stop
            status = torch.where(adv.stop, Status.EVENT.value, status)
        status = status.to(torch.int32)

        inc = any_running.to(torch.int32)
        ctx = StepContext(
            running=state.running,
            accept=accept,
            step_active=inc,
            n_f_evals=n_f_evals,
            n_written=n_written,
            err_ratio=err_ratio,
            aux=aux,
            n_events=adv.n_new if adv is not None else None,
        )
        stats = self._apply_stat_updates(dict(state.stats), ctx)
        if self.fused_mode is not None:
            stats["n_fused_steps"] = (
                stats["n_fused_steps"] + inc * state.running.to(torch.int32)
            )
        return committed._replace(running=running, status=status, stats=stats, ys=ys,
                                  it=state.it + inc)

    def step(self, state: LoopState, consts, args) -> LoopState:
        if self.fused_mode is not None:
            return self._step_fused(state, consts, args)
        stepper = self.stepper
        atol, rtol = self._tolerances(state.y)
        will_finish, safe_dt, t_new, window = self._attempt(state, consts)

        # --- one RK step for the whole batch ---
        res = stepper.step(self.term, state.t, safe_dt, state.y, state.f0, args,
                           carry=state.scarry, scale=self._scale(state.y))
        err_ratio = ops.error_norm(res.err, state.y, res.y1, atol, rtol)
        if res.solver_failed is not None:
            # A failed nonlinear solve is a hard reject through the ordinary
            # controller path: an infinite error ratio shrinks that
            # instance's step and retries.
            err_ratio = torch.where(res.solver_failed, float("inf"), err_ratio)

        # --- per-instance accept/reject + next step proposal ---
        accept, dt_next, cstate_new = self.controller(
            err_ratio, state.dt, state.cstate, stepper.error_order
        )
        accept = accept & state.running
        if res.solver_failed is not None:
            # Never commit a failed solve, even under an always-accept
            # controller (FixedController): it retries until max_steps, a
            # visible failure instead of a wrong SUCCESS.
            accept = accept & ~res.solver_failed

        # The dense-output interpolant of this step is shared by the eval-point
        # writer and the event localizer.
        dense_now = self.dense and consts[0] is not None
        coeffs = (
            stepper.interp_coeffs(state.y, res.y1, state.f0, res.f1, safe_dt)
            if dense_now or self.events else None
        )

        # --- masked commit ---
        acc_f = accept[:, None]
        committed = state._replace(
            t=torch.where(accept, t_new, state.t),
            dt=torch.where(state.running, dt_next, state.dt),
            y=torch.where(acc_f, res.y1, state.y),
            f0=torch.where(acc_f, res.f1, state.f0),
            scarry=stepper.commit_carry(state.scarry, res.carry, accept, state.running),
            # Every controller returns its own next state, so the loop
            # threads it uniformly.
            cstate=cstate_new,
        )
        return self._advance(state, consts, committed, args, y1=res.y1, accept=accept,
                             will_finish=will_finish, t_new=t_new, safe_dt=safe_dt,
                             window=window, coeffs=coeffs, n_f_evals=res.n_f_evals,
                             err_ratio=err_ratio, aux=res.stats_aux)

    def _step_fused(self, state: LoopState, consts, args) -> LoopState:
        """The fused fast path: everything between the stage evaluations and
        the loop-state rebuild -- b_sol/b_err combine, WRMS error norm,
        controller decision, masked commit of (t, y, f, dt) under ``running``
        and the Hermite coefficients -- is one ``ops.fused_step``.  For a
        ``PolynomialTerm`` the stage evaluations fuse too
        (``ops.fused_step_poly``): one launch per attempt, no vf launch.

        Mirrors ``step`` expression for expression: on the CPU the ops are
        composed of the same plain primitives in the same order, so fused and
        unfused solves are bitwise equal; on the card the kernels share their
        arithmetic with the unfused ones (``csrc/solver_common.cuh``).
        Non-FSAL tableaus evaluate the trailing derivative f(t + dt, y1) on
        every attempt, as ``rk_step`` does: by one more Horner pass inside
        ``fused_step_poly``, or by one vf call between the stage sweep and
        ``fused_step`` for a general term.  ``DiagonallyImplicitRK`` runs the
        factor-once chord-Newton sweep (``fused_stage_parts``) and hands the
        per-instance ``solver_failed`` mask to ``fused_step`` as ``failed``,
        which forces an infinite error ratio before the controller decides
        and keeps those rows out of ``accept`` -- the unfused path's
        failure-to-reject rule, in the kernel.  A ``PolynomialTerm`` under an
        implicit stepper takes this general path, never ``fused_step_poly``.
        """
        term, stepper = self.term, self.stepper
        atol, rtol = self._tolerances(state.y)
        will_finish, safe_dt, t_new, window = self._attempt(state, consts)

        tab = stepper.tableau
        # Fixed-step tableaus have no embedded estimate: zero error weights
        # (the in-kernel norm is then 0, as on the unfused path).
        a, c, b_sol, b_err = _tableau_arrays(tab, state.y.dtype)
        common = (
            state.t, t_new, state.dt, safe_dt, state.running,
            state.cstate.prev_inv_ratio, state.cstate.prev2_inv_ratio, atol, rtol,
        )
        kw = dict(b_sol=b_sol, b_err=b_err,
                  ctrl=self.controller.filter_params(stepper.error_order),
                  want_coeffs=bool(self.dense and consts[0] is not None or self.events),
                  ctrl_mode=self.fused_mode)
        scarry, failed, aux = state.scarry, None, None
        if self.fused_implicit:
            K, f1, n_f_evals, carry_prop, failed, aux = stepper.fused_stage_parts(
                term, state.t, safe_dt, state.y, state.f0, args, state.scarry,
                self._scale(state.y),
            )
            # f0: the cache a rejected row keeps.  K[0] is not f(t, y) when
            # the first stage is implicit (ROADMAP C-7).
            out = ops.fused_step(state.y, K, f1, *common, failed=failed, f0=state.f0, **kw)
        elif isinstance(term, PolynomialTerm) and term.poly_coeffs:
            out = ops.fused_step_poly(state.y, state.f0, *common, a=a, c=c,
                                      poly=term.poly_coeffs, fsal=tab.fsal, **kw)
            # The in-kernel stage evaluations count as the vf calls they
            # replace (non-FSAL: one more for the trailing evaluation).
            n_f_evals = tab.stages - 1 + (0 if tab.fsal else 1)
        else:
            K, n_f_evals = stepper.stage_derivatives(
                term, state.t, safe_dt, state.y, state.f0, args
            )
            if tab.fsal:
                f1 = K[-1]
            else:
                f1, extra = stepper.trailing_derivative(
                    term, state.t, safe_dt, state.y, K, args
                )
                n_f_evals += extra
            out = ops.fused_step(state.y, K, f1, *common, **kw)
        (y1, err_ratio, accept, y_out, f_out, t_out, dt_out,
         new_inv, new_inv2, coeffs) = out

        if self.fused_implicit:
            scarry = stepper.commit_carry(state.scarry, carry_prop, accept, state.running)
        # The masked commit is done in-kernel.
        committed = state._replace(t=t_out, dt=dt_out, y=y_out, f0=f_out, scarry=scarry,
                                   cstate=ControllerState(new_inv, new_inv2))
        return self._advance(state, consts, committed, args, y1=y1, accept=accept,
                             will_finish=will_finish, t_new=t_new, safe_dt=safe_dt,
                             window=window, coeffs=coeffs, n_f_evals=n_f_evals,
                             err_ratio=err_ratio, aux=aux)

    def finish(self, state: LoopState, consts) -> Solution:
        t_eval, t_start, t_end, direction = consts
        status = torch.where(
            state.running, Status.REACHED_MAX_STEPS.value, state.status
        ).to(torch.int32)
        stats = dict(state.stats)
        extra = {}
        if self.events:
            extra = dict(
                event_t=state.estate.t,
                event_y=state.estate.y,
                event_mask=state.estate.fired,
            )
        if self.dense and t_eval is not None:
            return Solution(ts=t_eval, ys=state.ys, status=status, stats=stats, **extra)
        # Without t_eval, report the per-instance time actually reached:
        # t_end on SUCCESS (the final step lands there exactly), the event
        # time on EVENT, and the last accepted time for early stops.
        return Solution(ts=state.t, ys=state.y, status=status, stats=stats, **extra)
