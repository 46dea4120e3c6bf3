"""8-bit AdamW moments (the JAX package's ``optim/quantized.py``):
blockwise-symmetric int8 along the last dim with a float32 scale per
256-entry block, dequantized for the float32 Adam math and quantized again
after it.  Moments take 2 bytes a parameter (and a scale per block) where
float32 ones take 8.  Plain functions on dicts of tensors, in place, as
``adamw.py``.

Under a mesh the buffers are DTensors in the placements the reference's
rules give their own shapes.  A block must be the unsharded step's block
of 256 whatever the mesh, so the blockwise math runs with the last dim
whole (``_last_dim_whole``): a leaf whose last dim is sharded is gathered
along it for the (de)quantization and written back in its own placements.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..distributed.constraints import assign_
from .adamw import AdamWConfig, _step0, bias_corrections, cosine_lr

BLOCK = 256


def quantize_blockwise(x):
    """Blockwise-symmetric int8 along the LAST dim (padded to BLOCK): the
    quantized buffers keep the parameter's leading dims.  Returns q int8
    (*lead, ceil(n/B)*B) and scales float32 (*lead, ceil(n/B))."""
    pad = (-x.shape[-1]) % BLOCK
    xp = torch.nn.functional.pad(x, (0, pad))
    blocks = xp.reshape(*xp.shape[:-1], -1, BLOCK)
    scale = torch.clamp(blocks.abs().amax(dim=-1) / 127.0, min=1e-20)
    q = torch.clamp(torch.round(blocks / scale[..., None]), -127, 127).to(torch.int8)
    return q.reshape(xp.shape), scale


def dequantize_blockwise(q, scale, shape):
    blocks = q.reshape(*q.shape[:-1], -1, BLOCK).float() * scale[..., None]
    return blocks.reshape(*q.shape[:-1], -1)[..., : shape[-1]]


def _last_dim_whole(t):
    """``t``, a DTensor redistributed so that its last dim is not sharded
    (the blocks of 256 are then whole on every rank)."""
    if not isinstance(t, DTensor):
        return t
    last = t.ndim - 1
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == last else p for p in t.placements)
    return t if pl == tuple(t.placements) else t.redistribute(t.device_mesh, pl)


def qadamw_init(params):
    """Quantized zero moments ({"q", "s"} per parameter) and step 0."""
    def one(p):
        q, s = quantize_blockwise(_last_dim_whole(torch.zeros_like(p, dtype=torch.float32)))
        return {"q": q, "s": s}

    return {"m": {k: one(p) for k, p in params.items()},
            "v": {k: one(p) for k, p in params.items()},
            "step": _step0(params)}


def qadamw_update(cfg: AdamWConfig, params, grads, state):
    """One AdamW step on 8-bit moments, in place.  Returns (params, state,
    {"lr": lr})."""
    step = state["step"] + 1
    lr = cosine_lr(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1, bc2 = bias_corrections(cfg, step)
    with torch.no_grad():
        for name, p in params.items():
            gf = grads[name].float()
            mq, vq = state["m"][name], state["v"][name]
            m = dequantize_blockwise(_last_dim_whole(mq["q"]), _last_dim_whole(mq["s"]), p.shape)
            v = dequantize_blockwise(_last_dim_whole(vq["q"]), _last_dim_whole(vq["s"]), p.shape)
            m = b1 * m + (1 - b1) * gf
            v = b2 * v + (1 - b2) * gf * gf
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p.float()
            assign_(p, (p.float() - lr * delta).to(p.dtype))
            for moment, buf in ((m, mq), (v, vq)):
                q, s = quantize_blockwise(_last_dim_whole(moment))
                assign_(buf["q"], q)
                assign_(buf["s"], s)
    state["step"] = step
    return params, state, {"lr": lr}
