"""Adaptive step-size controllers with fully batched per-instance state.

Implements the Soederlind (2002, 2003) digital-filter family: the next step
factor is

    factor = safety * e_n^{-b1/k} * e_{n-1}^{-b2/k} * e_{n-2}^{-b3/k}

where ``e`` are weighted-RMS error ratios (accept iff e <= 1) and ``k`` is the
error-estimator order + 1.  b = (1, 0, 0) is the integral (I) controller used by
torchdiffeq/TorchDyn; torchode additionally ships PI/PID coefficient sets.

Every quantity -- error history, proposed dt, accept decision -- is a (batch,)
tensor: instances never share a step size.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..kernels import ops


class ControllerState(NamedTuple):
    # inverse error ratios of the previous two accepted steps (init 1.0)
    prev_inv_ratio: torch.Tensor  # (b,)
    prev2_inv_ratio: torch.Tensor  # (b,)


class _ControllerStats:
    """Statistics-registry contribution shared by all controllers: the
    controller owns the accept/reject decision, so it records ``n_accepted``."""

    def init_stats(self, batch: int) -> dict[str, torch.Tensor]:
        return {"n_accepted": torch.zeros((batch,), dtype=torch.int32)}

    def update_stats(self, stats: dict, ctx) -> dict:
        return {**stats, "n_accepted": stats["n_accepted"] + ctx.accept.to(torch.int32)}


@dataclasses.dataclass(frozen=True)
class PIDController(_ControllerStats):
    """General PID step controller; I/PI controllers are coefficient choices.

    Coefficients follow the convention of torchode / diffrax docs: they are
    divided by the controller order ``k`` internally.  Frozen, compared by
    value.
    """

    pcoeff: float = 0.0
    icoeff: float = 1.0
    dcoeff: float = 0.0
    safety: float = 0.9
    factor_min: float = 0.2
    factor_max: float = 10.0
    dt_min: float = 0.0
    dt_max: float = float("inf")

    def init(self, batch: int, dtype, device=None) -> ControllerState:
        one = torch.ones((batch,), dtype=dtype, device=device)
        return ControllerState(one, one)

    def betas(self, k: int) -> tuple[float, float, float]:
        # Soederlind exponents for (e_n, e_{n-1}, e_{n-2}) given PID coefficients.
        b1 = (self.pcoeff + self.icoeff + self.dcoeff) / k
        b2 = -(self.pcoeff + 2.0 * self.dcoeff) / k
        b3 = self.dcoeff / k
        return b1, b2, b3

    def filter_params(self, k: int) -> tuple[float, ...]:
        """The controller's coefficient tuple ``(b1, b2, b3, safety,
        factor_min, factor_max, dt_min, dt_max)`` -- the constants the fused
        step kernel takes by value for its accept/next-dt tail."""
        return (*self.betas(k), self.safety, self.factor_min, self.factor_max,
                self.dt_min, self.dt_max)

    def __call__(
        self,
        err_ratio: torch.Tensor,  # (b,) weighted RMS error ratio of this step
        dt: torch.Tensor,  # (b,) step size just attempted (signed)
        state: ControllerState,
        k: int,  # error-estimator order + 1
    ) -> tuple[torch.Tensor, torch.Tensor, ControllerState]:
        """Returns (accept (b,) bool, dt_next (b,) signed, new state).
        Delegates to ``ops.pid_update``."""
        b1, b2, b3 = self.betas(k)
        accept, dt_next, new_inv, new_inv2 = ops.pid_update(
            err_ratio, dt, state.prev_inv_ratio, state.prev2_inv_ratio,
            b1=b1, b2=b2, b3=b3, safety=self.safety,
            factor_min=self.factor_min, factor_max=self.factor_max,
            dt_min=self.dt_min, dt_max=self.dt_max,
        )
        return accept, dt_next, ControllerState(new_inv, new_inv2)


def integral_controller(**kw) -> PIDController:
    """The I controller of torchdiffeq/TorchDyn (b = (1, 0, 0))."""
    return PIDController(pcoeff=0.0, icoeff=1.0, dcoeff=0.0, **kw)


def pi_controller(**kw) -> PIDController:
    """A common PI coefficient choice (0.3/0.4 rule)."""
    return PIDController(pcoeff=0.3, icoeff=0.4, dcoeff=0.0, **kw)


def pid_controller(**kw) -> PIDController:
    """PID coefficients from diffrax's documentation (as used in the paper's App. C)."""
    return PIDController(pcoeff=0.2, icoeff=0.3, dcoeff=0.1, **kw)


@dataclasses.dataclass(frozen=True)
class FixedController(_ControllerStats):
    """Fixed-step 'controller': always accept, keep dt (euler/rk4 style)."""

    dt_min: float = 0.0
    dt_max: float = float("inf")

    def init(self, batch: int, dtype, device=None) -> ControllerState:
        one = torch.ones((batch,), dtype=dtype, device=device)
        return ControllerState(one, one)

    def filter_params(self, k: int) -> tuple[float, ...]:
        """No filter coefficients: the fused step runs with
        ``ctrl_mode="fixed"`` instead -- accept everything that is running,
        keep the standing dt proposal and pass the history through, exactly
        what ``__call__`` and the loop's masked commit compute unfused."""
        return ()

    def __call__(self, err_ratio, dt, state, k):
        accept = torch.ones(dt.shape, dtype=torch.bool, device=dt.device)
        return accept, dt, state
