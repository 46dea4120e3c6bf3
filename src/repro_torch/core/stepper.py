"""Runge-Kutta stepping: the swappable "step method" component.

``AbstractStepper`` is the protocol every step method implements -- seed the
derivative cache and the cross-step carry (``init``/``init_carry``), advance
(``step``), merge the carry (``commit_carry``), interpolate
(``interp_coeffs``), propose a first step (``initial_step_size``) and
contribute to the statistics registry (``init_stats``/``update_stats``).

``ExplicitRK`` is the tableau + FSAL explicit path (``Stepper`` is an alias).
One ``step`` computes all stage derivatives, the solution update and the
embedded error estimate through the ops in ``repro_torch.kernels.ops``:
``s - 1`` ``stage_accum`` launches, then one ``fused_update``.  The fused step
path (``StepFunction(fused=True)``) takes the stages alone
(``stage_derivatives``, plus ``trailing_derivative`` for non-FSAL tableaus)
and hands them to ``ops.fused_step``.

``DiagonallyImplicitRK`` is the SDIRK/ESDIRK path for stiff problems: each
implicit stage is solved by the batched masked chord-Newton layer
(``core/newton.py``) against ``M = I - dt*gamma*J``, with the Jacobian
carried across steps and refreshed per instance.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..kernels import ops
from .newton import NewtonConfig, newton_solve
from .tableau import ButcherTableau, get_tableau
from .terms import ODETerm


class StepResult(NamedTuple):
    y1: torch.Tensor  # (b, f) candidate next state
    err: torch.Tensor  # (b, f) embedded error estimate (zeros for fixed-step)
    f1: torch.Tensor  # (b, f) f(t + dt, y1) -- exact for FSAL/SSAL tableaus
    n_f_evals: Any  # dynamics evaluations in this step (int)
    carry: Any = ()  # stepper-private cross-step state proposal (e.g. Jacobian)
    solver_failed: torch.Tensor | None = None  # (b,) bool: nonlinear solve failed
    stats_aux: dict | None = None  # extra per-step stats (n_newton_iters, ...)


def _tableau_arrays(tab: ButcherTableau, dtype):
    """Tableau coefficients as host-side numpy (a, c, b_sol, b_err) in the
    state's dtype: the kernels take them by value at launch.  Fixed-step
    tableaus (b_err is None) get zero error weights."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    a = np.asarray(tab.a, dtype=np_dtype)
    c = np.asarray(tab.c, dtype=np_dtype)
    b_sol = np.asarray(tab.b_sol, dtype=np_dtype)
    b_err = (
        np.asarray(tab.b_err, dtype=np_dtype)
        if tab.b_err is not None
        else np.zeros((tab.stages,), dtype=np_dtype)
    )
    return a, c, b_sol, b_err


def rk_step(
    term: ODETerm,
    tab: ButcherTableau,
    t: torch.Tensor,  # (b,)
    dt: torch.Tensor,  # (b,)
    y: torch.Tensor,  # (b, f)
    f0: torch.Tensor,  # (b, f) derivative at (t, y); FSAL cache
    args: Any,
) -> StepResult:
    _, _, b_sol, b_err = _tableau_arrays(tab, y.dtype)
    K, n_evals = stage_derivatives(term, tab, t, dt, y, f0, args)
    y1, err = ops.fused_update(y, K, dt, b_sol, b_err)

    if tab.fsal:
        f1 = K[-1]
    else:
        f1 = term.vf(t + dt, y1, args)
        n_evals += 1
    return StepResult(y1=y1, err=err, f1=f1, n_f_evals=n_evals)


def stage_derivatives(term, tab, t, dt, y, f0, args):
    """The stacked stage slopes K (s, b, f) of one explicit step, without the
    b_sol/b_err combination.  Returns ``(K, n_f_evals)``.

    The stages live in one (s, b, f) buffer, so each ``stage_accum`` reads
    the contiguous prefix K[:i] instead of a fresh stack of the stages so far.
    """
    a, c, _, _ = _tableau_arrays(tab, y.dtype)
    K = torch.empty((tab.stages,) + tuple(y.shape), dtype=y.dtype, device=y.device)
    K[0] = f0  # stage 0 is always f(t, y) == the FSAL cache
    for i in range(1, tab.stages):
        yi = ops.stage_accum(y, dt, K[:i], a[i, :i])
        K[i] = term.vf(t + float(c[i]) * dt, yi, args)
    return K, tab.stages - 1


def initial_step_size(
    term: ODETerm,
    t0: torch.Tensor,  # (b,)
    y0: torch.Tensor,  # (b, f)
    f0: torch.Tensor,  # (b, f)
    direction: torch.Tensor,  # (b,) +-1
    order: int,
    atol,
    rtol,
    args: Any = None,
    *,
    dt_min: float = 0.0,
    dt_max: float = float("inf"),
) -> torch.Tensor:
    """Hairer/Noersett/Wanner automatic initial step selection, vectorized.

    The proposal magnitude is clamped to ``[dt_min, dt_max]``.
    """
    atol, rtol = ops.broadcast_tolerances(atol, rtol, y0.dtype, y0.device)
    scale = atol + torch.abs(y0) * rtol

    def rms(x):
        return ops.rms_norm(x, scale)

    d0 = rms(y0)
    d1 = rms(f0)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6,
                     0.01 * d0 / torch.clamp(d1, min=1e-30))

    y1 = y0 + (h0 * direction)[:, None] * f0
    f1 = term.vf(t0 + h0 * direction, y1, args)
    d2 = rms(f1 - f0) / torch.clamp(h0, min=1e-30)

    dmax = torch.maximum(d1, d2)
    h1 = torch.where(
        dmax <= 1e-15,
        torch.clamp(h0 * 1e-3, min=1e-6),
        (0.01 / torch.clamp(dmax, min=1e-30)) ** (1.0 / order),
    )
    h = torch.clamp(torch.minimum(100.0 * h0, h1), dt_min, dt_max)
    return h * direction


class AbstractStepper:
    """The step-method protocol the drivers and ``StepFunction`` compose.

    A stepper owns a tableau, keeps all cross-step state in the loop-carried
    ``carry`` it proposes, and contributes named per-instance accumulators to
    the statistics registry.  Concrete steppers are frozen dataclasses,
    compared by value.
    """

    tableau: ButcherTableau

    @staticmethod
    def coerce(value: "AbstractStepper | str | ButcherTableau | None") -> "AbstractStepper":
        """Normalize the stepper argument accepted by drivers/StepFunction:
        explicit tableaus get an ``ExplicitRK``, implicit ones a
        ``DiagonallyImplicitRK``."""
        if value is None:
            return ExplicitRK()
        if isinstance(value, AbstractStepper):
            return value
        tab = get_tableau(value) if isinstance(value, str) else value
        return DiagonallyImplicitRK(tab) if tab.implicit else ExplicitRK(tab)

    @property
    def order(self) -> int:
        return self.tableau.order

    @property
    def error_order(self) -> int:
        return self.tableau.error_order

    @property
    def is_adaptive(self) -> bool:
        return self.tableau.b_err is not None

    def init(self, term: ODETerm, t0, y0, args: Any) -> torch.Tensor:
        """Seed the derivative cache: f(t0, y0) (the FSAL seed)."""
        return term.vf(t0, y0, args)

    def init_carry(self, term: ODETerm, t0, y0, f0, args) -> Any:
        """Build the stepper's cross-step carry (lives in ``LoopState``).
        Explicit methods carry nothing; implicit ones carry the Jacobian and
        its per-instance refresh mask."""
        return ()

    def step(self, term, t, dt, y, f0, args, carry=(), scale=None) -> StepResult:
        raise NotImplementedError

    def commit_carry(self, old: Any, new: Any, accept: torch.Tensor,
                     running: torch.Tensor) -> Any:
        """Merge the step's proposed carry into the loop state.  Default:
        advance the carry for running instances, freeze it for finished ones
        (the carry is valid for accepted AND rejected attempts -- a Jacobian
        evaluated at (t, y) stays correct when the step is retried with a
        smaller dt)."""

        def mask(n, o):
            if n.ndim == 0:  # batch-shared scalar leaves advance as proposed
                return n
            return torch.where(running.reshape(running.shape + (1,) * (n.ndim - 1)), n, o)

        return pytree.tree_map(mask, new, old)

    def interp_coeffs(self, y0, y1, f0, f1, dt):
        """Dense-output interpolant coefficients (cubic Hermite, Horner form)."""
        return ops.hermite_coeffs(y0, y1, f0, f1, dt)

    def initial_step_size(
        self, term, t0, y0, f0, direction, atol, rtol, args: Any = None,
        *, dt_min: float = 0.0, dt_max: float = float("inf"),
    ) -> torch.Tensor:
        return initial_step_size(
            term, t0, y0, f0, direction, self.tableau.order, atol, rtol, args,
            dt_min=dt_min, dt_max=dt_max,
        )

    # --- statistics registry contribution ---
    def init_stats(self, batch: int) -> dict[str, torch.Tensor]:
        return {"n_f_evals": torch.zeros((batch,), dtype=torch.int32)}

    def update_stats(self, stats: dict, ctx) -> dict:
        return {
            **stats,
            "n_f_evals": stats["n_f_evals"] + ctx.step_active * ctx.n_f_evals,
        }

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.tableau.name!r})"


@dataclasses.dataclass(frozen=True, repr=False)
class ExplicitRK(AbstractStepper):
    """Tableau + explicit RK step + interpolant; stateless across steps.

    Construct from a method name or an explicit tableau::

        ExplicitRK("tsit5")
        ExplicitRK(my_tableau)

    Contributes ``n_f_evals`` to the statistics registry (the per-step
    evaluation count, shared across the batch because the dynamics run on
    the full batch while any instance is running).
    """

    method: str | ButcherTableau = dataclasses.field(default="dopri5", compare=False)
    tableau: ButcherTableau = dataclasses.field(init=False)

    def __post_init__(self):
        tab = get_tableau(self.method) if isinstance(self.method, str) else self.method
        if tab.implicit:
            raise ValueError(
                f"tableau {tab.name!r} has implicit stages; use DiagonallyImplicitRK"
            )
        object.__setattr__(self, "tableau", tab)

    def step(self, term, t, dt, y, f0, args, carry=(), scale=None):
        return rk_step(term, self.tableau, t, dt, y, f0, args)

    def stage_derivatives(self, term, t, dt, y, f0, args):
        """The stacked stage slopes K (s, b, f) without the b_sol/b_err
        combination, through the same ``stage_accum`` recursion as
        ``rk_step`` -- the fused step hands K to ``ops.fused_step``.
        Returns ``(K, n_f_evals)``."""
        return stage_derivatives(term, self.tableau, t, dt, y, f0, args)

    def trailing_derivative(self, term, t, dt, y, K, args):
        """The non-FSAL trailing evaluation f(t + dt, y1) the fused step
        feeds to ``ops.fused_step`` as ``f1``.  y1 comes from the same
        ``fused_update`` the kernel applies inside, and, as in ``rk_step``,
        the evaluation happens on every attempt, accepted or not.  Returns
        ``(f1, n_f_evals_delta)``."""
        _, _, b_sol, b_err = _tableau_arrays(self.tableau, y.dtype)
        y1, _ = ops.fused_update(y, K, dt, b_sol, b_err)
        return term.vf(t + dt, y1, args), 1


# Compatibility alias: the pre-hierarchy name of the explicit stepper.
Stepper = ExplicitRK


class DIRKCarry(NamedTuple):
    """Cross-step state of ``DiagonallyImplicitRK``: the chord Jacobian and
    the per-instance mask asking for it to be re-evaluated next step."""

    jac: torch.Tensor  # (b, f, f) df/dy from a previous step (possibly stale)
    refresh: torch.Tensor  # (b,) bool


@dataclasses.dataclass(frozen=True, repr=False, init=False)
class DiagonallyImplicitRK(AbstractStepper):
    """SDIRK/ESDIRK stepper for stiff problems, batched Newton inside.

    Every implicit stage shares the tableau's single diagonal coefficient
    ``gamma``, so one chord matrix ``M = I - dt*gamma*J`` (per instance)
    serves all stages of a step.  ``J`` comes from ``ODETerm.vf_jac`` and is
    reused across stages *and* steps; an instance re-evaluates it only when
    its ``refresh`` flag is set (Newton failed or converged slowly).  Where
    the JAX package branches on the device (``lax.cond(any(refresh))``), a
    step here reads ``refresh.any()`` once: ``vf_jac`` runs for the whole
    batch only when some row asks, and is masked by ``refresh``.

    All inner-solver knobs live on ONE object: pass
    ``newton=NewtonConfig(tol=..., max_iters=..., divergence_rate=...,
    slow_iters=...)``.  The legacy loose kwargs (``newton_tol``,
    ``max_newton_iters``, ``slow_iters``) are deprecated aliases that emit a
    ``DeprecationWarning`` and cannot be combined with ``newton=``.

    Statistics: ``n_f_evals`` (batched Newton evaluations, overhanging),
    ``n_newton_iters`` (per-instance inner iterations while running) and
    ``n_jac_evals`` (per-instance Jacobian evaluations).
    """

    tableau: ButcherTableau
    newton: NewtonConfig
    gamma: float = dataclasses.field(compare=False)

    def __init__(
        self,
        method: str | ButcherTableau = "kvaerno5",
        *,
        newton: NewtonConfig | None = None,
        newton_tol: float | None = None,
        max_newton_iters: int | None = None,
        slow_iters: int | None = None,
    ):
        tab = get_tableau(method) if isinstance(method, str) else method
        if not tab.implicit:
            raise ValueError(f"tableau {tab.name!r} is explicit; use ExplicitRK")
        legacy = {
            "newton_tol": newton_tol,
            "max_newton_iters": max_newton_iters,
            "slow_iters": slow_iters,
        }
        used = [name for name, v in legacy.items() if v is not None]
        if used:
            if newton is not None:
                raise TypeError(
                    f"cannot combine newton= with legacy kwarg(s) {used}; "
                    "put every knob on the NewtonConfig"
                )
            warnings.warn(
                f"DiagonallyImplicitRK kwarg(s) {used} are deprecated; pass "
                "newton=NewtonConfig(tol=..., max_iters=..., slow_iters=...) instead",
                DeprecationWarning,
                stacklevel=2,
            )
            newton = NewtonConfig(
                tol=newton_tol if newton_tol is not None else 1e-2,
                max_iters=max_newton_iters if max_newton_iters is not None else 8,
                slow_iters=slow_iters,
            )
        object.__setattr__(self, "tableau", tab)
        object.__setattr__(self, "newton", newton if newton is not None else NewtonConfig())
        object.__setattr__(self, "gamma", tab.diagonal)  # validates the constant diagonal

    # The pre-NewtonConfig knob names, kept readable.
    @property
    def newton_tol(self) -> float:
        return self.newton.tol

    @property
    def max_newton_iters(self) -> int:
        return self.newton.max_iters

    @property
    def slow_iters(self) -> int:
        return self.newton.effective_slow_iters

    @property
    def _last_stage_is_f1(self) -> bool:
        """Stiffly accurate with c_s == 1: the last stage derivative IS
        f(t + dt, y1), so no trailing evaluation is needed."""
        return self.tableau.stiffly_accurate and self.tableau.c[-1] == 1.0

    def init_carry(self, term, t0, y0, f0, args) -> DIRKCarry:
        b, f = y0.shape
        return DIRKCarry(
            jac=torch.zeros((b, f, f), dtype=y0.dtype, device=y0.device),
            refresh=torch.ones((b,), dtype=torch.bool, device=y0.device),
        )

    def _stage_sweep(self, term, t, dt, y, f0, args, carry, scale, *, factor_once):
        """The stage recursion shared by the unfused and fused DIRK paths:
        per-instance Jacobian refresh, chord-matrix build, and one masked
        Newton solve per implicit stage.  ``factor_once=False`` re-solves
        against ``M`` every iteration (``batched_linsolve``);
        ``factor_once=True`` factors ``M`` once (``ops.batched_lu_factor``)
        and runs every iteration as one ``ops.fused_newton_iter``.  The two
        give identical iterates, so fused and unfused DIRK solves are equal
        bitwise.

        Returns ``(K, carry_out, failed, n_static_evals, n_evals, stats_aux)``.
        """
        tab = self.tableau
        dtype = y.dtype
        a, c, _, _ = _tableau_arrays(tab, dtype)
        if not isinstance(carry, DIRKCarry):
            carry = self.init_carry(term, t, y, f0, args)
        if scale is None:
            # Direct-call default: the solver's default tolerances.
            scale = 1e-6 + 1e-3 * torch.abs(y)

        # --- per-instance Jacobian refresh (skipped when nobody asks) ---
        if bool(carry.refresh.any()):
            J = torch.where(carry.refresh[:, None, None], term.vf_jac(t, y, args), carry.jac)
        else:
            J = carry.jac
        n_jac_evals = carry.refresh.to(torch.int32)
        eye = torch.eye(y.shape[1], dtype=dtype, device=y.device)
        M = eye - (dt * self.gamma)[:, None, None] * J
        operator = ops.batched_lu_factor(M) if factor_once else None

        K = torch.empty((tab.stages,) + tuple(y.shape), dtype=dtype, device=y.device)
        failed = torch.zeros(dt.shape, dtype=torch.bool, device=y.device)
        slow = torch.zeros(dt.shape, dtype=torch.bool, device=y.device)
        n_newton_iters = torch.zeros(dt.shape, dtype=torch.int32, device=y.device)
        n_evals = 0
        n_static_evals = 0
        slow_iters = self.newton.effective_slow_iters
        tiny = torch.finfo(dtype).tiny
        for i in range(tab.stages):
            ti = t + float(c[i]) * dt
            y_pred = y if i == 0 else ops.stage_accum(y, dt, K[:i], a[i, :i])
            if a[i, i] == 0.0:  # explicit stage (the E in ESDIRK)
                if i == 0:
                    K[0] = f0
                else:
                    K[i] = term.vf(ti, y_pred, args)
                    n_static_evals += 1
            else:
                dtg = (dt * float(a[i, i]))[:, None]

                def eval_fn(k, ti=ti, y_pred=y_pred, dtg=dtg):
                    return term.vf(ti, y_pred + dtg * k, args)

                # Convergence is measured on the stage VALUE increment
                # dt*a_ii*delta_k (state units), not the raw slope update,
                # so the test matches the atol/rtol error scale.
                stage_scale = scale / torch.clamp(torch.abs(dtg), min=tiny)
                pred = K[i - 1] if i > 0 else f0  # predictor: the previous stage slope
                if K.requires_grad:
                    # Autograd saves the first iterate, and K[i] is written below.
                    pred = pred.clone()
                if factor_once:
                    res = newton_solve(eval_fn, pred, scale=stage_scale, operator=operator,
                                       config=self.newton)
                else:
                    res = newton_solve(eval_fn, pred, M, stage_scale, config=self.newton)
                K[i] = res.k
                failed = failed | ~res.converged
                slow = slow | (res.n_iters >= slow_iters)
                n_newton_iters = n_newton_iters + res.n_iters
                n_evals += res.n_evals

        stats_aux = {"n_newton_iters": n_newton_iters, "n_jac_evals": n_jac_evals}
        carry_out = DIRKCarry(jac=J, refresh=failed | slow)
        return K, carry_out, failed, n_static_evals, n_evals, stats_aux

    def step(self, term, t, dt, y, f0, args, carry=(), scale=None):
        _, _, b_sol, b_err = _tableau_arrays(self.tableau, y.dtype)
        K, carry_out, failed, n_static_evals, n_evals, stats_aux = self._stage_sweep(
            term, t, dt, y, f0, args, carry, scale, factor_once=False
        )
        y1, err = ops.fused_update(y, K, dt, b_sol, b_err)
        if self._last_stage_is_f1:
            f1 = K[-1]
        else:
            f1 = term.vf(t + dt, y1, args)
            n_static_evals += 1
        return StepResult(
            y1=y1,
            err=err,
            f1=f1,
            n_f_evals=n_evals + n_static_evals,
            carry=carry_out,
            solver_failed=failed,
            stats_aux=stats_aux,
        )

    def fused_stage_parts(self, term, t, dt, y, f0, args, carry, scale):
        """The DIRK half of the fused path: the stage sweep with the
        factor-once Newton strategy (one ``batched_lu_factor`` per step
        attempt, one ``fused_newton_iter`` per Newton iteration), plus the
        trailing derivative -- everything ``ops.fused_step`` needs.  The
        combine, norm, controller and commit happen in the kernel, with the
        per-instance ``solver_failed`` mask as its ``failed=`` input, so a
        failed solve still lands as a controller reject.

        Returns ``(K, f1, n_f_evals, carry, solver_failed, stats_aux)``.
        """
        K, carry_out, failed, n_static_evals, n_evals, stats_aux = self._stage_sweep(
            term, t, dt, y, f0, args, carry, scale, factor_once=True
        )
        if self._last_stage_is_f1:
            f1 = K[-1]
        else:
            # y1 through the same fused_update the kernel applies inside,
            # then one trailing vf call -- as ``step`` does.
            _, _, b_sol, b_err = _tableau_arrays(self.tableau, y.dtype)
            y1, _ = ops.fused_update(y, K, dt, b_sol, b_err)
            f1 = term.vf(t + dt, y1, args)
            n_static_evals += 1
        return K, f1, n_evals + n_static_evals, carry_out, failed, stats_aux

    def commit_carry(self, old, new, accept, running):
        """Advance the Jacobian for running instances.  Two refresh-flag
        refinements: a rejected step that already ran on a FRESH Jacobian
        (old.refresh was set) retries at the same (t, y), where re-evaluating
        would reproduce J bit for bit -- drop the flag and let the dt shrink
        do the work; and finished instances drop their flag, so a frozen
        instance never keeps triggering whole-batch re-evaluation."""
        wasteful = old.refresh & ~accept
        return DIRKCarry(
            jac=torch.where(running[:, None, None], new.jac, old.jac),
            refresh=new.refresh & ~wasteful & running,
        )

    # --- statistics registry contribution ---
    def init_stats(self, batch: int) -> dict[str, torch.Tensor]:
        zeros = torch.zeros((batch,), dtype=torch.int32)
        return {"n_f_evals": zeros, "n_newton_iters": zeros.clone(),
                "n_jac_evals": zeros.clone()}

    def update_stats(self, stats: dict, ctx) -> dict:
        aux = ctx.aux or {}
        running = ctx.running.to(torch.int32)
        out = {
            **stats,
            "n_f_evals": stats["n_f_evals"] + ctx.step_active * ctx.n_f_evals,
        }
        if "n_newton_iters" in aux:
            out["n_newton_iters"] = (
                stats["n_newton_iters"] + ctx.step_active * running * aux["n_newton_iters"]
            )
        if "n_jac_evals" in aux:
            out["n_jac_evals"] = (
                stats["n_jac_evals"] + ctx.step_active * running * aux["n_jac_evals"]
            )
        return out
