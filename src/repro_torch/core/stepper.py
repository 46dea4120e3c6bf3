"""Runge-Kutta stepping: the swappable "step method" component.

``AbstractStepper`` is the protocol every step method implements -- seed the
derivative cache (``init``), advance (``step``), interpolate
(``interp_coeffs``), propose a first step (``initial_step_size``) and
contribute to the statistics registry (``init_stats``/``update_stats``).

``ExplicitRK`` is the tableau + FSAL explicit path (``Stepper`` is an alias).
One ``step`` computes all stage derivatives, the solution update and the
embedded error estimate through the ops in ``repro_torch.kernels.ops``:
``s - 1`` ``stage_accum`` launches, then one ``fused_update``.  The fused step
path (``StepFunction(fused=True)``) takes the stages alone
(``stage_derivatives``, plus ``trailing_derivative`` for non-FSAL tableaus)
and hands them to ``ops.fused_step``.

The diagonally implicit steppers are not ported yet (ROADMAP A-10).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from ..kernels import ops
from .tableau import ButcherTableau, get_tableau
from .terms import ODETerm


class StepResult(NamedTuple):
    y1: torch.Tensor  # (b, f) candidate next state
    err: torch.Tensor  # (b, f) embedded error estimate (zeros for fixed-step)
    f1: torch.Tensor  # (b, f) f(t + dt, y1) -- exact for FSAL/SSAL tableaus
    n_f_evals: Any  # dynamics evaluations in this step (int)


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

    A stepper owns a tableau, keeps no state across steps, and contributes
    named per-instance accumulators to the statistics registry.  Concrete
    steppers are frozen dataclasses, compared by value.
    """

    tableau: ButcherTableau

    @staticmethod
    def coerce(value: "AbstractStepper | str | ButcherTableau | None") -> "AbstractStepper":
        """Normalize the stepper argument accepted by drivers/StepFunction:
        explicit tableaus get an ``ExplicitRK``.  Implicit tableaus raise
        until ``DiagonallyImplicitRK`` is ported."""
        if value is None:
            return ExplicitRK()
        if isinstance(value, AbstractStepper):
            return value
        tab = get_tableau(value) if isinstance(value, str) else value
        if tab.implicit:
            raise NotImplementedError(
                f"implicit method {tab.name!r}: DiagonallyImplicitRK is not ported "
                "yet (ROADMAP A-10)"
            )
        return ExplicitRK(tab)

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

    def step(self, term, t, dt, y, f0, args) -> StepResult:
        raise NotImplementedError

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
                f"tableau {tab.name!r} has implicit stages; "
                "use DiagonallyImplicitRK (not ported yet, ROADMAP A-10)"
            )
        object.__setattr__(self, "tableau", tab)

    def step(self, term, t, dt, y, f0, args):
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
