"""AdamW with global-norm clipping and a cosine schedule (the JAX package's
``optim/adamw.py``), as plain functions on dicts of tensors.

``params`` and ``grads`` map names to tensors (``dict(model.named_parameters())``);
the state holds float32 moments under the same names and the step count.
The update keeps the reference's expressions and order: float32 moments,
the decoupled weight decay inside ``delta``, and the new parameter cast
back to the parameter's dtype.  Unlike the reference, which returns new
trees, it writes the parameters and moments in place (a 3B model's float32
moments are 21 GB) and returns the same dicts.

Under a mesh the parameters, gradients and moments are DTensors (the
moments in their parameter's placements, ``distributed.state_shardings``):
the same loop runs on them, each write keeping its destination's
placements, and the global norm sums over every shard (its value is a
replicated DTensor).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..distributed.constraints import assign_


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def _step0(params):
    p = next(iter(params.values()))
    device = p.to_local().device if hasattr(p, "to_local") else p.device
    return torch.zeros((), dtype=torch.int32, device=device)


def adamw_init(params):
    """Zero float32 moments of each parameter's shape on its device, and
    step 0 (int32)."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)  # a DTensor keeps its placements

    return {"m": {k: zeros(p) for k, p in params.items()},
            "v": {k: zeros(p) for k, p in params.items()},
            "step": _step0(params)}


def cosine_lr(cfg: AdamWConfig, step):
    """Linear warm-up to ``cfg.lr``, then a cosine to 0 at
    ``cfg.total_steps``; float32, of a step tensor."""
    step = step.float()
    warm = step / max(1.0, cfg.warmup_steps)
    prog = (step - cfg.warmup_steps) / max(1.0, cfg.total_steps - cfg.warmup_steps)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def clip_by_global_norm(grads, max_norm):
    """(the gradients scaled by min(1, max_norm / ||g||), ||g||): the norm
    over every gradient in float32, each scaled gradient in its dtype."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, gn


def bias_corrections(cfg: AdamWConfig, step):
    """(1 - b1^step, 1 - b2^step) in float32."""
    step = step.float()
    return 1.0 - torch.pow(cfg.b1, step), 1.0 - torch.pow(cfg.b2, step)


def adamw_update(cfg: AdamWConfig, params, grads, state):
    """One AdamW step, in place.  Returns (params, state, {"lr": lr})."""
    step = state["step"] + 1
    lr = cosine_lr(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1, bc2 = bias_corrections(cfg, step)
    with torch.no_grad():
        for name, p in params.items():
            gf = grads[name].float()
            m, v = state["m"][name], state["v"][name]
            m_new = b1 * m + (1 - b1) * gf
            v_new = b2 * v + (1 - b2) * gf * gf
            mh = m_new / bc1
            vh = v_new / bc2
            delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
            p_new = p.float() - lr * delta
            assign_(p, p_new.to(p.dtype))
            assign_(m, m_new)
            assign_(v, v_new)
    state["step"] = step
    return params, state, {"lr": lr}
