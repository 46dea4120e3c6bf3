"""Continuous normalizing flow (FFJORD-style) on a 2-D density, trained with
the JOINT adjoint backward (the paper's torchode-joint fast path).

    PYTHONPATH=src python -m repro_torch.examples.cnf_density [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.adjoint import make_adjoint_solve
from ..tools.cnf import aug_dynamics, clip_tree, init_mlp, nll_loss, two_moons
from . import example_device, parser

ITERS = 60


def main(device="cuda", iters=ITERS, params=None, data=None):
    """60 momentum steps on 512 two-moons points.  ``params`` / ``data``
    replace the MLP and the points drawn from seed 0 (the run takes their
    dtype); ``iters`` the iteration count.  The final NLL's assert is the
    reference's after its 60 iterations, made when ``iters`` reaches them.
    Returns the NLL of every iteration, the first gradient (before
    clipping) and the final parameters."""
    dev = example_device(device)
    if params is None:
        params = init_mlp(torch.Generator().manual_seed(0))
    if data is None:
        data = two_moons(torch.Generator().manual_seed(0), 512)
    params = {k: torch.as_tensor(v).to(dev) for k, v in params.items()}
    x = torch.as_tensor(data).to(dev)
    solve = make_adjoint_solve(aug_dynamics, mode="joint", rtol=1e-4, atol=1e-4, device=dev)

    lr, m = 1e-2, {k: torch.zeros_like(v) for k, v in params.items()}
    history, first = [], None
    for it in range(iters):
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        nll = nll_loss(p, x, solve)
        g = dict(zip(p, torch.autograd.grad(nll, list(p.values()))))
        if first is None:
            first = g
        g = clip_tree(g)
        m = {k: 0.9 * m[k] + g[k] for k in m}
        params = {k: params[k] - lr * m[k] for k in params}
        history.append(float(nll.detach()))
        if it % 10 == 0:
            print(f"iter {it:3d}  nll {history[-1]:.4f}")
    print(f"final nll {history[-1]:.4f} (standard-normal baseline "
          f"{0.5*2*np.log(2*np.pi) + 1.0:.4f})")
    if iters >= ITERS:
        assert history[-1] < 2.5, "CNF should beat the unit-gaussian baseline"
    return {"nll": history, "first_grads": first, "params": params}


if __name__ == "__main__":
    main(parser(__doc__).parse_args().device)
