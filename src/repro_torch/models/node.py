"""Continuous-depth ("neural ODE") execution of a transformer block stack
(the JAX package's ``models/node.py``), driven by the port's batch-parallel
solver -- where the paper's solver meets the LM.

dx/dt = block(x, t), t in [0, 1], weight-tied across depth (``n_periods``
must be 1).  Each sequence is one ODE instance of s * d float32 entries, so
every sequence adapts its own step size.  ``solve_ivp_scan`` (``ScanAdjoint``)
integrates it with bosh3 at rtol 1e-2, atol 1e-3 for ``cfg.ode_steps`` loop
iterations; on the card its stages, update and error norm are the CUDA
kernels with their autograd Functions, and the block's attention the CUDA
forward and backward.

Under a mesh the instances are independent (the paper's batch
parallelism): the residual stream is anchored batch-on-dp, replicated on
"model", and each rank solves its own batch rows with the blocks' weights
gathered whole (``distributed.constraints.rows_map``), so the solver
kernels never see a DTensor.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from ..core import solve_ivp_scan
from ..distributed.constraints import constrain, rows_map
from .common import apply_norm


def forward_ode(cfg, params, batch):
    """``forward`` of an ``LM`` (``params``) whose config has ``ode_depth``:
    (logits (b, s, vocab), {"ode_steps": the mean accepted steps})."""
    if cfg.n_periods != 1:
        raise ValueError("ode_depth requires a weight-tied (single-period) stack")
    x = constrain(params._embed_tokens(batch), "dp", None, None)
    dtype = getattr(torch, cfg.dtype)

    def depth(x):
        """The solve of each row of x (b, s, d): (x at t = 1, the accepted steps)."""
        b, s, d = x.shape
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)

        def dyn(t, y, _args):
            # y: (b, s*d) -- each sequence is one ODE instance
            h = y.reshape(b, s, d).to(dtype)
            out = h
            for blk in params.blocks:
                out, _, _ = blk.apply_seq(out, positions, mode="train")
            return (out - h).reshape(b, s * d).to(y.dtype)

        y0 = x.reshape(b, s * d).float()
        sol = solve_ivp_scan(dyn, y0, None, t_start=0.0, t_end=1.0, method="bosh3", rtol=1e-2,
                             atol=1e-3, max_steps=cfg.ode_steps, device=x.device)
        return sol.ys.reshape(b, s, d).to(dtype), sol.stats["n_steps"].float()

    if isinstance(x, DTensor):
        x, n_steps = rows_map(depth, params.blocks, x)
    else:
        x, n_steps = depth(x)
    x = apply_norm(cfg, x, params.final_norm, "")
    logits = constrain(x @ params.embed.T, "dp", None, "tp")
    return logits, {"ode_steps": n_steps.mean()}
