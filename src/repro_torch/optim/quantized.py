"""8-bit AdamW moments (the JAX package's ``optim/quantized.py``):
blockwise-symmetric int8 along the last dim with a float32 scale per
256-entry block, dequantized for the float32 Adam math and quantized again
after it.  Moments take 2 bytes a parameter (and a scale per block) where
float32 ones take 8.  Plain functions on dicts of tensors, in place, as
``adamw.py``.
"""

from __future__ import annotations

import torch

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


def qadamw_init(params):
    """Quantized zero moments ({"q", "s"} per parameter) and step 0."""
    def one(p):
        q, s = quantize_blockwise(torch.zeros(p.shape, dtype=torch.float32, device=p.device))
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
            m = dequantize_blockwise(mq["q"], mq["s"], p.shape)
            v = dequantize_blockwise(vq["q"], vq["s"], p.shape)
            m = b1 * m + (1 - b1) * gf
            v = b2 * v + (1 - b2) * gf * gf
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
            for moment, buf in ((m, mq), (v, vq)):
                q, s = quantize_blockwise(moment)
                buf["q"].copy_(q)
                buf["s"].copy_(s)
    state["step"] = step
    return params, state, {"lr": lr}
