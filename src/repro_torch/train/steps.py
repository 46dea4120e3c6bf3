"""Serve-step functions (the JAX package's ``train/steps.py``):
``make_prefill_step`` and ``make_decode_step``.  The training step comes
with the LM's training path (ROADMAP A-17)."""

from __future__ import annotations

from ..models import decode_step as model_decode
from ..models import prefill


def make_prefill_step(cfg):
    def prefill_step(params, batch):
        return prefill(cfg, params, batch)

    return prefill_step


def make_decode_step(cfg):
    def decode_fn(params, token, pos, cache):
        return model_decode(cfg, params, token, pos, cache)

    return decode_fn
