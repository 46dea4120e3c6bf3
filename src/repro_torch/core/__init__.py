"""repro_torch.core -- batch-parallel adaptive ODE solving in PyTorch.

The port of the JAX package's ``repro.core``, slice by slice.  Two API levels:

  - one-call wrappers: ``solve_ivp`` / ``solve_ivp_scan`` / ``make_solver``
  - composable components: ``AutoDiffAdjoint(Stepper("tsit5"),
    pid_controller()).solve(f, y0, t_eval)``

Every entry point runs on the CUDA device unless the caller passes
``device="cpu"``.
"""

from .controller import (
    ControllerState,
    FixedController,
    PIDController,
    integral_controller,
    pi_controller,
    pid_controller,
)
from .drivers import AutoDiffAdjoint, BacksolveAdjoint, ScanAdjoint
from .events import Event, EventState
from .loop import make_solver, solve_ivp, solve_ivp_scan
from .newton import NewtonConfig, NewtonResult, newton_solve
from .solution import Grads, Solution, Status
from .step import FusedFallbackReason, LoopState, StepContext, StepFunction
from .stepper import (
    AbstractStepper,
    DiagonallyImplicitRK,
    DIRKCarry,
    ExplicitRK,
    Stepper,
    StepResult,
    initial_step_size,
    rk_step,
)
from .tableau import TABLEAUS, ButcherTableau, get_tableau
from .terms import (
    ODETerm,
    PolynomialTerm,
    RaveledState,
    as_term,
    polynomial_term,
    ravel_state,
    ravel_term,
)

__all__ = [
    "AbstractStepper",
    "DiagonallyImplicitRK",
    "DIRKCarry",
    "ExplicitRK",
    "NewtonConfig",
    "NewtonResult",
    "newton_solve",
    "Stepper",
    "StepResult",
    "initial_step_size",
    "rk_step",
    "ControllerState",
    "FixedController",
    "PIDController",
    "integral_controller",
    "pi_controller",
    "pid_controller",
    "AutoDiffAdjoint",
    "BacksolveAdjoint",
    "ScanAdjoint",
    "Event",
    "EventState",
    "make_solver",
    "solve_ivp",
    "solve_ivp_scan",
    "Grads",
    "Solution",
    "Status",
    "FusedFallbackReason",
    "LoopState",
    "StepContext",
    "StepFunction",
    "TABLEAUS",
    "ButcherTableau",
    "get_tableau",
    "ODETerm",
    "PolynomialTerm",
    "RaveledState",
    "as_term",
    "polynomial_term",
    "ravel_state",
    "ravel_term",
]
