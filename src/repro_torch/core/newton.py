"""Batched masked Newton/chord iteration for the implicit stage equations.

The paper's per-instance principle pushed down into the *inner* nonlinear
solve: every ODE instance in the batch iterates its own Newton sequence and
stops on its own through a convergence mask, as the outer loop freezes
finished instances.  One iteration performs one batched vector-field
evaluation and one batched linear solve; instances that already converged (or
failed) stop updating but keep riding along (the inner-loop analogue of
torchode's "overhanging evaluations").

The iteration is a *chord* Newton: the matrix ``M = I - dt*gamma*J`` is built
once per solver step from a (possibly stale, per-instance refreshed) Jacobian
and reused across all stages and iterations.  Two linear-algebra strategies
share the loop:

``M`` path
    Each iteration runs a batched dense solve against ``M``
    (``ops.batched_linsolve``) followed by the masked commit and convergence
    norm (``ops.masked_newton_update``).

``operator`` path (factor once)
    The caller factors ``M`` once per step with ``ops.batched_lu_factor``
    and every iteration runs ONE ``ops.fused_newton_iter``: residual,
    permutation gather, the two triangular substitutions against the
    prefactored LU, masked commit and scaled-RMS norm.  ``batched_linsolve``
    is that factorization followed by that substitution, so both paths give
    identical iterates (bitwise on the CPU, and on the card, where the
    kernels share their device functions).

Where the JAX package loops on the device (``lax.while_loop`` with the
condition ``any(active) & (it < max_iters)``), this loop runs in Python and
reads ``active.any()`` once per iteration: one host sync per Newton
iteration.  The overhanging evaluation count ``n_evals`` is then the
reference's exactly, and a stage whose rows have all converged launches
nothing more.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from ..kernels import ops


@dataclasses.dataclass(frozen=True)
class NewtonConfig:
    """The inner nonlinear solver's knobs as one frozen, hashable object:
    ``DiagonallyImplicitRK`` carries a ``NewtonConfig``, so the knobs take
    part in the stepper's value equality.

    tol
        Convergence threshold for the scaled RMS of the Newton update,
        measured in the step's atol/rtol error units.
    max_iters
        Per-stage iteration cap; exhausting it marks the instance failed.
    divergence_rate
        Growth factor of the update norm between iterations that counts as
        divergence.
    slow_iters
        Iteration count at or above which a *converged* instance is still
        considered slow, scheduling a Jacobian refresh for its next step.
        ``None`` (the default) derives ``max(2, max_iters // 2)``.
    """

    tol: float = 1e-2
    max_iters: int = 8
    divergence_rate: float = 2.0
    slow_iters: int | None = None

    @property
    def effective_slow_iters(self) -> int:
        """The refresh threshold with the ``None`` default resolved."""
        if self.slow_iters is not None:
            return self.slow_iters
        return max(2, self.max_iters // 2)


class NewtonResult(NamedTuple):
    k: torch.Tensor  # (b, f) solved stage derivative (where converged)
    converged: torch.Tensor  # (b,) bool: update norm fell below tol
    diverged: torch.Tensor  # (b,) bool: non-finite residual or growing iterates
    n_iters: torch.Tensor  # (b,) int32: iterations while this instance was active
    n_evals: int  # batched vf evaluations (overhanging count)


def newton_solve(
    eval_fn: Callable[[torch.Tensor], torch.Tensor],
    k0: torch.Tensor,  # (b, f) initial iterate (predictor)
    M: torch.Tensor | None = None,  # (b, f, f) chord matrix I - dt*gamma*J
    scale: torch.Tensor | None = None,  # (b, f) error scale atol + rtol*|y|
    *,
    operator: tuple[torch.Tensor, torch.Tensor] | None = None,
    config: NewtonConfig | None = None,
) -> NewtonResult:
    """Solve ``k = eval_fn(k)`` per instance by masked chord-Newton iteration.

    ``eval_fn`` is the batched stage map ``k -> f(t_i, y_pred + dt*a_ii*k)``;
    the residual is ``g(k) = k - eval_fn(k)`` and each iteration applies
    ``k <- k - M^{-1} g(k)`` where an instance is still active.  Convergence is
    per instance: the scaled RMS of the update falls below ``config.tol``
    (in the same atol/rtol units as the step acceptance test).  Divergence --
    non-finite values or the update norm growing by more than
    ``config.divergence_rate`` between iterations -- deactivates the instance
    with ``diverged`` set; the stepper reports that through the controller's
    reject path.

    The linear solve comes from exactly one of two sources:

    - ``M``: the chord matrix itself; each iteration runs a fresh batched
      dense solve (``ops.batched_linsolve``).
    - ``operator``: the ``(lu, permutation)`` pair from
      ``ops.batched_lu_factor(M)``; each iteration runs the single
      ``ops.fused_newton_iter`` against the prefactored LU.

    All numeric knobs live on ``config`` (``None`` means the defaults).
    """
    if (M is None) == (operator is None):
        raise TypeError("newton_solve needs exactly one of M= or operator=")
    if scale is None:
        raise TypeError("newton_solve requires scale")
    cfg = config if config is not None else NewtonConfig()
    tol, max_iters, divergence_rate = cfg.tol, cfg.max_iters, cfg.divergence_rate
    b, device = k0.shape[0], k0.device

    k = k0
    active = torch.ones((b,), dtype=torch.bool, device=device)
    converged = torch.zeros((b,), dtype=torch.bool, device=device)
    diverged = torch.zeros((b,), dtype=torch.bool, device=device)
    n_iters = torch.zeros((b,), dtype=torch.int32, device=device)
    prev_norm = torch.full((b,), float("inf"), dtype=k0.dtype, device=device)
    it = 0
    # The reference's while_loop condition, read on the host once per
    # iteration (ROADMAP A-16 moves it onto the device).
    while it < max_iters and bool(active.any()):
        if operator is not None:
            lu, perm = operator
            k_new, res_norm = ops.fused_newton_iter(lu, perm, k, eval_fn(k), active, scale)
        else:
            g = k - eval_fn(k)
            delta = ops.batched_linsolve(M, g)
            k_new, res_norm = ops.masked_newton_update(k, delta, active, scale)
        finite = torch.isfinite(res_norm)
        conv_now = active & finite & (res_norm <= tol)
        div_now = active & (~finite | ((it > 0) & (res_norm > divergence_rate * prev_norm)))
        k = k_new
        n_iters = n_iters + active.to(torch.int32)
        prev_norm = torch.where(active, res_norm, prev_norm)
        active = active & ~conv_now & ~div_now
        converged = converged | conv_now
        diverged = diverged | div_now
        it += 1
    return NewtonResult(
        k=k,
        converged=converged,
        diverged=diverged | (active & ~converged),
        n_iters=n_iters,
        n_evals=it,
    )
