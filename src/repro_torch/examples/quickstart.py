"""Quickstart: the paper's Listing 1, in the port.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The reference (``examples/quickstart.py``) jits each solve; here they run
eagerly, the kernels on the card.
"""

from __future__ import annotations

import torch
import torch.utils._pytree as pytree

from ..core import (
    AutoDiffAdjoint,
    Status,
    Stepper,
    integral_controller,
    pid_controller,
    solve_ivp,
)
from . import example_device, parser


def vdp(t, y, mu):
    x, xdot = y[..., 0], y[..., 1]
    return torch.stack((xdot, mu * (1 - x**2) * xdot - x), dim=-1)


def vdp_tree(t, y, mu):
    x, xdot = y["x"], y["v"]["xdot"]
    return {"x": xdot, "v": {"xdot": mu * (1 - x**2) * xdot - x}}


def main(device="cuda", data=None):
    """The reference's script; ``data`` replaces the (5, 2) initial states
    drawn from seed 0 (their dtype is the solves').  Returns the four
    solutions: ``sol`` (the one-liner), ``sol2`` (the component API),
    ``sol_pid`` and ``sol3`` (the dict state)."""
    dev = example_device(device)
    batch_size, mu = 5, 10.0
    if data is None:
        data = torch.randn((batch_size, 2), generator=torch.Generator().manual_seed(0))
    y0 = torch.as_tensor(data).to(dev)
    t_eval = torch.linspace(0.0, 10.0, 50, dtype=y0.dtype, device=dev)

    sol = solve_ivp(vdp, y0, t_eval, method="tsit5", args=mu, device=dev)

    print("status:", sol.status.tolist())  # => [0, 0, 0, 0, 0]
    assert bool((sol.status == Status.SUCCESS.value).all())
    print("stats:")
    for k, v in sorted(sol.stats.items()):
        print(f"  {k}: {v.tolist() if isinstance(v, torch.Tensor) else v}")
    # Per-instance step counts differ (independent adaptive stepping);
    # n_f_evals is shared across the batch (the dynamics run on the full batch
    # every iteration, "overhanging evaluations" included) -- exactly
    # torchode's Listing 1 output.

    # --- the same solve through the component API ----------------------------
    # Term, stepper, controller and driver are independently swappable; this
    # is the paper's AutoDiffAdjoint(stepper, controller) construction.
    solver = AutoDiffAdjoint(Stepper("tsit5"), integral_controller())
    sol2 = solver.solve(vdp, y0, t_eval, args=mu, device=dev)
    assert torch.allclose(sol2.ys, sol.ys, atol=1e-5)
    print("component API matches the one-liner")

    # Swapping the controller is a one-word change -- PID takes a different
    # (usually shorter) step sequence, so results agree only to tolerance:
    pid_solver = AutoDiffAdjoint(Stepper("tsit5"), pid_controller())
    sol_pid = pid_solver.solve(vdp, y0, t_eval, args=mu, device=dev)
    print("pid n_steps:", sol_pid.stats["n_steps"].tolist(), "vs integral:",
          sol2.stats["n_steps"].tolist())

    # --- structured states -----------------------------------------------------
    # Initial states may be nested dicts (leaves batched on axis 0); the
    # vector field then receives one instance's dict with a scalar t.  The hot
    # loop still runs on flat (batch, features) buffers.
    y0_tree = {"x": y0[:, :1], "v": {"xdot": y0[:, 1:]}}
    sol3 = solver.solve(vdp_tree, y0_tree, t_eval, args=mu, device=dev)
    print("pytree ys shapes:", pytree.tree_map(lambda a: tuple(a.shape), sol3.ys))
    assert torch.allclose(sol3.ys["x"], sol.ys[..., :1], atol=1e-4)
    print("pytree solve matches the flat solve")
    return {"sol": sol, "sol2": sol2, "sol_pid": sol_pid, "sol3": sol3}


if __name__ == "__main__":
    main(parser(__doc__).parse_args().device)
