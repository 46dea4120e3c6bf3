"""Abstract input specs (the JAX package's ``launch/specs.py``) for every
(arch x shape) cell: tensors on the ``meta`` device, which carry shape and
dtype and allocate nothing -- the counterparts of ``jax.ShapeDtypeStruct``
and ``jax.eval_shape``.  The sharding rules take them
(``distributed.param_shardings(mesh, abstract_params(cfg))``)."""

from __future__ import annotations

import torch

from ..models import LM, init_cache
from ..models.config import SHAPES, ArchConfig
from ..optim import adamw_init
from ..optim.quantized import BLOCK


def abstract_params(cfg: ArchConfig):
    """The LM of ``cfg`` on the meta device (its parameters uninitialized)."""
    return LM(cfg, device="meta")


def abstract_train_state(cfg: ArchConfig, optimizer: str = "adamw"):
    """``train.steps.init_train_state``'s tree on the meta device; 8-bit
    moments as ``qadamw_init`` shapes them (int8 blocks padded along the
    last dim to a multiple of BLOCK, a float32 scale per block)."""
    params = abstract_params(cfg)
    named = dict(params.named_parameters())
    if optimizer != "adamw8bit":
        return {"params": params, "opt": adamw_init(named)}

    def moment(p):
        *lead, n = p.shape
        nb = -(-n // BLOCK)
        return {"q": sds((*lead, nb * BLOCK), torch.int8), "s": sds((*lead, nb), torch.float32)}

    return {"params": params, "opt": {"m": {k: moment(p) for k, p in named.items()},
                                      "v": {k: moment(p) for k, p in named.items()},
                                      "step": sds((), torch.int32)}}


def sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, shape_name: str, *, with_labels: bool):
    """Token/label/frontend-embedding specs for full-sequence steps."""
    sh = SHAPES[shape_name]
    b, s = sh["global_batch"], sh["seq_len"]
    dtype = getattr(torch, cfg.dtype)
    batch = {"tokens": sds((b, s), torch.int32)}
    if with_labels:
        batch["labels"] = sds((b, s), torch.int32)
    if cfg.n_img_tokens > 0:
        batch["img_embeds"] = sds((b, cfg.n_img_tokens, cfg.d_model), dtype)
    if cfg.enc_dec:
        # mechanical: encoder frame count mirrors the assigned seq length
        batch["audio_embeds"] = sds((b, s, cfg.d_model), dtype)
    return batch


def decode_specs(cfg: ArchConfig, shape_name: str, *, enc_len: int = 1500):
    """(token, pos, cache) specs for one-token decode with a seq_len cache."""
    sh = SHAPES[shape_name]
    b, s = sh["global_batch"], sh["seq_len"]
    cache = init_cache(cfg, b, s, device="meta", enc_len=enc_len if cfg.enc_dec else None)
    return sds((b,), torch.int32), sds((b,), torch.int32), cache


def cell_runnable(cfg: ArchConfig, shape_name: str) -> tuple[bool, str]:
    """Shape-cell applicability per the assignment rules."""
    if shape_name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k needs sub-quadratic attention; skipped for full-attention arch"
    return True, ""
