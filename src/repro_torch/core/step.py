"""The shared ``init/step/finish`` step function of the batch-parallel solver.

``StepFunction`` composes the three swappable components -- ``ODETerm``
(dynamics), a stepper (``ExplicitRK``: tableau + stage recursion +
interpolant) and a controller -- into one adaptive solver step for the whole
batch.  ``AutoDiffAdjoint`` in ``drivers.py`` iterates it; ``make_solver`` in
``loop.py`` exposes the bare function triple for callers that build their own
loop.

Every instance in the batch carries its own time, step size, controller
history, accept/reject decision and termination status.  Instances that
finish early keep being *evaluated* (the dynamics run on the full batch --
torchode's "overhanging evaluations") but their state is frozen by masking,
so results are unaffected.  A step itself never synchronizes host and
device; the driver's loop condition does, once per step.

Statistics registry
-------------------
``LoopState.stats`` is a dict of named per-instance ``(b,)`` accumulators.
Each component contributes entries via an ``init_stats(batch) -> dict`` hook
and advances them in ``update_stats(stats, ctx) -> dict``, where ``ctx`` is a
``StepContext`` describing the step just taken.  The stepper records
``n_f_evals``, the controller ``n_accepted``, the step function itself
``n_steps`` and ``n_initialized``; user code can register additional
contributors through ``extra_stats``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ..kernels import ops
from .controller import ControllerState, FixedController, _ControllerStats, integral_controller
from .solution import Solution, Status
from .stepper import AbstractStepper
from .terms import ODETerm, as_term


class LoopState(NamedTuple):
    t: torch.Tensor  # (b,) current time
    dt: torch.Tensor  # (b,) signed step proposal for the next attempt
    y: torch.Tensor  # (b, f)
    f0: torch.Tensor  # (b, f) FSAL derivative cache at (t, y)
    cstate: ControllerState
    running: torch.Tensor  # (b,) bool
    status: torch.Tensor  # (b,) int32
    stats: dict[str, torch.Tensor]  # named (b,) accumulators (statistics registry)
    ys: torch.Tensor  # (b, n, f) dense output buffer (or (b, 0, f) when unused)
    it: torch.Tensor  # () int32 global iteration counter


class StepContext(NamedTuple):
    """What a statistics contributor may observe about the step just taken."""

    running: torch.Tensor  # (b,) bool: running mask *before* this step
    accept: torch.Tensor  # (b,) bool: accepted this step (masked by running)
    step_active: torch.Tensor  # () int32: 1 while any instance runs (overhanging evals)
    n_f_evals: Any  # dynamics-evaluation count of this step (int)
    n_written: torch.Tensor  # (b,) int32: dense-output points written this step
    err_ratio: torch.Tensor  # (b,) weighted RMS error ratio of this step


def refuse_unported(events, fused) -> None:
    """Raise for the features whose slices are not ported yet; they stay in
    the signatures for parity with the JAX package."""
    if events is not None and events != ():
        raise NotImplementedError("events are not ported yet (ROADMAP A-9)")
    if fused:
        raise NotImplementedError(
            "fused=True (the fused_step kernel) is not ported yet (ROADMAP A-8, B-5)"
        )


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

    ``events``, ``event_bisect_iters`` and ``fused`` stay in the signature
    for parity with the JAX package: events and ``fused=True`` are refused
    until their slices are ported.
    """

    term: ODETerm
    stepper: AbstractStepper | str | None = None
    controller: Any = None
    _: dataclasses.KW_ONLY
    rtol: Any = 1e-3
    atol: Any = 1e-6
    dense: bool = True
    dense_window: int = 0
    events: dataclasses.InitVar[Any] = None
    event_bisect_iters: dataclasses.InitVar[int] = 30
    extra_stats: tuple = ()
    fused: dataclasses.InitVar[bool] = False
    stat_contributors: tuple = dataclasses.field(init=False, repr=False)

    def __post_init__(self, events, event_bisect_iters, fused):
        refuse_unported(events, fused)
        stepper = AbstractStepper.coerce(self.stepper)
        controller = self.controller
        if controller is None:
            controller = integral_controller() if stepper.is_adaptive else FixedController()
        extra_stats = tuple(self.extra_stats)
        # Registry order: component contributions first, loop bookkeeping last.
        # Duck-typed controllers without the registry hooks still get
        # n_accepted recorded.
        controller_stats = controller if hasattr(controller, "init_stats") else _ControllerStats()
        for name, value in (
            ("term", as_term(self.term)),
            ("stepper", stepper),
            ("controller", controller),
            ("extra_stats", extra_stats),
            ("stat_contributors", (stepper, controller_stats, self, *extra_stats)),
        ):
            object.__setattr__(self, name, value)

    # --- the step function's own statistics contribution ---
    def init_stats(self, batch: int) -> dict[str, torch.Tensor]:
        zeros = torch.zeros((batch,), dtype=torch.int32)
        return {"n_steps": zeros, "n_initialized": zeros.clone()}

    def update_stats(self, stats: dict, ctx: StepContext) -> dict:
        return {
            **stats,
            "n_steps": stats["n_steps"] + ctx.step_active * ctx.running.to(torch.int32),
            "n_initialized": stats["n_initialized"] + ctx.n_written,
        }

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
            cstate=self.controller.init(b, dtype, device),
            running=torch.ones((b,), dtype=torch.bool, device=device),
            status=torch.zeros((b,), dtype=torch.int32, device=device),
            stats=stats,
            ys=ys,
            it=torch.zeros((), dtype=torch.int32, device=device),
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

    def step(self, state: LoopState, consts, args) -> LoopState:
        term, stepper, controller = self.term, self.stepper, self.controller
        k = stepper.error_order
        t_eval, t_start, t_end, direction = consts
        finfo = torch.finfo(state.y.dtype)
        atol, rtol = self._tolerances(state.y)

        any_running = state.running.any()

        dt_prop, cursor, t_win, W = self._propose(state, consts)

        # --- clamp the attempt so the final step lands exactly on t_end ---
        rem = t_end - state.t
        will_finish = torch.abs(dt_prop) >= torch.abs(rem)
        dt_used = torch.where(will_finish, rem, dt_prop)
        safe_dt = torch.where(torch.abs(dt_used) > finfo.tiny, dt_used, 1.0)

        # --- one RK step for the whole batch ---
        res = stepper.step(term, state.t, safe_dt, state.y, state.f0, args)
        err_ratio = ops.error_norm(res.err, state.y, res.y1, atol, rtol)

        # --- per-instance accept/reject + next step proposal ---
        accept, dt_next, cstate_new = controller(err_ratio, state.dt, state.cstate, k)
        accept = accept & state.running

        t_new = torch.where(will_finish, t_end, state.t + dt_used)
        done_now = accept & will_finish

        # step-size floor: instances whose step collapses are stopped
        dt_floor = 8.0 * finfo.eps * torch.maximum(torch.abs(state.t), torch.abs(t_end))
        nonfinite_y = ~torch.all(torch.isfinite(res.y1), dim=-1)
        stopped = state.running & ~accept & (torch.abs(dt_next) <= dt_floor)

        # --- dense output: write every eval point passed by this step ---
        dense_now = self.dense and t_eval is not None
        coeffs = (
            stepper.interp_coeffs(state.y, res.y1, state.f0, res.f1, safe_dt)
            if dense_now else None
        )
        ys, n_written = self._write_dense(
            state, consts, coeffs, accept, t_new, safe_dt, cursor, t_win, W
        )

        # --- masked commit ---
        acc_f = accept[:, None]
        y = torch.where(acc_f, res.y1, state.y)
        f0 = torch.where(acc_f, res.f1, state.f0)
        t = torch.where(accept, t_new, state.t)
        dt = torch.where(state.running, dt_next, state.dt)

        running = state.running & ~done_now & ~stopped
        status = torch.where(
            done_now,
            Status.SUCCESS.value,
            torch.where(
                stopped,
                torch.where(nonfinite_y, Status.INFINITE.value, Status.REACHED_DT_MIN.value),
                state.status,
            ),
        ).to(torch.int32)

        inc = any_running.to(torch.int32)
        ctx = StepContext(
            running=state.running,
            accept=accept,
            step_active=inc,
            n_f_evals=res.n_f_evals,
            n_written=n_written,
            err_ratio=err_ratio,
        )
        stats = self._apply_stat_updates(dict(state.stats), ctx)

        return LoopState(
            t=t,
            dt=dt,
            y=y,
            f0=f0,
            # Every controller returns its own next state, so the loop
            # threads it uniformly.
            cstate=cstate_new,
            running=running,
            status=status,
            stats=stats,
            ys=ys,
            it=state.it + inc,
        )

    def finish(self, state: LoopState, consts) -> Solution:
        t_eval, t_start, t_end, direction = consts
        status = torch.where(
            state.running, Status.REACHED_MAX_STEPS.value, state.status
        ).to(torch.int32)
        stats = dict(state.stats)
        if self.dense and t_eval is not None:
            return Solution(ts=t_eval, ys=state.ys, status=status, stats=stats)
        # Without t_eval, report the per-instance time actually reached:
        # t_end on SUCCESS (the final step lands there exactly) and the last
        # accepted time for early stops.
        return Solution(ts=state.t, ys=state.y, status=status, stats=stats)
