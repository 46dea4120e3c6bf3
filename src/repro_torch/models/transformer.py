"""Transformer blocks (the JAX package's ``models/transformer.py``), for the
kinds the port builds: ``attn_mlp`` (causal attention + MLP) and
``attn_bidir_mlp`` (bidirectional attention + MLP, full-sequence only),
for training, prefill and decode.

Weights keep the reference's (d_in, d_out) layout (``x @ wq``) and names, in
one ``nn.ParameterDict`` per sub-layer (``attn``, ``ln1``, ``mlp``,
``ln2``), so weights carry across from the reference as copies.  The large
projections and the MLP are ``torch.matmul``, as the reference leaves them
to XLA; the attention goes through ``attention.flash_attention`` (the CUDA
kernel on the card) when prefilling and ``decode_attention`` when decoding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .attention import decode_attention, flash_attention
from .common import apply_norm, apply_rope, dense_fill_, norm_params

KINDS = ("attn_mlp", "attn_bidir_mlp")


def check_kind(kind):
    if kind not in KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP A-17); the port builds {KINDS}")


def _qkv(cfg, p, x):
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(*x.shape[:-1], H, hd)
    k = k.reshape(*x.shape[:-1], KV, hd)
    v = v.reshape(*x.shape[:-1], KV, hd)
    return q, k, v


def _mlp(cfg, p, x):
    if cfg.mlp == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_in"])) @ p["w_out"]
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x @ p["w_in"], approximate="tanh") @ p["w_out"]


def _channel_mix(cfg, kind, p, x):
    """Second half of a block: the MLP over the residual stream.  ``p`` holds
    the block's ``mlp`` and ``ln2`` parameters.  Returns (x, aux)."""
    if kind.endswith("_mlp"):
        x = x + _mlp(cfg, p["mlp"], apply_norm(cfg, x, p["ln2"], ""))
    return x, {}


def _params(tensors):
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in tensors.items()})


class Block(nn.Module):
    """One layer of kind ``attn_mlp`` or ``attn_bidir_mlp``, its weights
    allocated uninitialized (biases zero, norms ones/zeros): ``init_params``
    draws them, ``load_state_dict`` loads them
    (``convert.lm_params_from_numpy``).  Every weight is a parameter that
    requires grad; ``apply_seq`` differentiates (the attention through
    ``autograd.FlashAttention``)."""

    def __init__(self, cfg, kind, *, device=None, dtype=None):
        super().__init__()
        check_kind(kind)
        self.cfg, self.kind = cfg, kind
        dtype = dtype or getattr(torch, cfg.dtype)
        d, H, KV, hd, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff

        def w(*shape):
            return torch.empty(shape, dtype=dtype, device=device)

        attn = {"wq": w(d, H * hd), "wk": w(d, KV * hd), "wv": w(d, KV * hd), "wo": w(H * hd, d)}
        if cfg.qkv_bias:
            attn.update({name: torch.zeros((n,), dtype=dtype, device=device)
                         for name, n in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd))})
        mlp = {"w_in": w(d, ff), "w_out": w(ff, d)}
        if cfg.mlp == "swiglu":
            mlp["w_gate"] = w(d, ff)
        self.attn = _params(attn)
        self.ln1 = _params(norm_params(cfg, d, device))
        self.mlp = _params(mlp)
        self.ln2 = _params(norm_params(cfg, d, device))

    @torch.no_grad()
    def init_params(self, generator):
        """Draw the weights from ``generator`` at the reference's
        ``dense_init`` scale, in the reference's order (wq, wk, wv, wo,
        w_in, w_out, w_gate)."""
        for name in ("wq", "wk", "wv", "wo"):
            dense_fill_(self.attn[name], generator)
        for name in ("w_in", "w_out", "w_gate"):
            if name in self.mlp:
                dense_fill_(self.mlp[name], generator)
        return self

    def apply_seq(self, x, positions, *, mode):
        """Full-sequence path (train/prefill), ``block_apply_seq``.  Returns
        (x, cache, aux); with ``mode == "prefill"`` the cache holds this
        layer's keys and values flat, ``{"k", "v"}: (b, s, KV * hd)``."""
        cfg = self.cfg
        h = apply_norm(cfg, x, self.ln1, "")
        q, k, v = _qkv(cfg, self.attn, h)
        if cfg.rope:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        o = flash_attention(q, k, v, causal=self.kind != "attn_bidir_mlp", q_chunk=cfg.q_chunk,
                            kv_chunk=cfg.kv_chunk)
        x = x + o.reshape(*x.shape[:-1], -1) @ self.attn["wo"]
        cache = None
        if mode == "prefill":
            b_, s_ = x.shape[0], x.shape[1]
            cache = {"k": k.reshape(b_, s_, -1), "v": v.reshape(b_, s_, -1)}
        x, aux = _channel_mix(cfg, self.kind, {"mlp": self.mlp, "ln2": self.ln2}, x)
        return x, cache, aux

    def apply_decode(self, x, pos, state):
        """One-token path, ``block_apply_decode``.  x: (b, d); pos: (b,);
        state: this layer's flat caches ``{"k", "v"}: (b, S, KV * hd)``.  The
        new key and value are written into the caches at ``pos`` in place
        (the reference returns updated copies).  Returns (x, state)."""
        if self.kind != "attn_mlp":
            raise ValueError(self.kind)  # as the reference: no decode without a causal cache
        cfg = self.cfg
        KV, hd = cfg.n_kv_heads, cfg.hd
        h = apply_norm(cfg, x[:, None, :], self.ln1, "")[:, 0]
        q, k, v = _qkv(cfg, self.attn, h)  # (b, H/KV, hd)
        if cfg.rope:
            q = apply_rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
            k = apply_rope(k[:, None], pos[:, None], cfg.rope_theta)[:, 0]
        b = x.shape[0]
        rows = torch.arange(b, device=x.device)
        k_cache, v_cache = state["k"], state["v"]
        k_cache[rows, pos] = k.reshape(b, -1)
        v_cache[rows, pos] = v.reshape(b, -1)
        S = k_cache.shape[1]
        o = decode_attention(q, k_cache.reshape(b, S, KV, hd), v_cache.reshape(b, S, KV, hd), pos)
        x = x + o.reshape(b, -1) @ self.attn["wo"]
        x = x + _mlp(cfg, self.mlp, apply_norm(cfg, x[:, None, :], self.ln2, "")[:, 0])
        return x, state
