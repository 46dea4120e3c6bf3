"""Transformer blocks (the JAX package's ``models/transformer.py``), every
kind the configs use: ``attn_mlp`` and ``attn_moe`` (causal attention, then
an MLP or a MoE), ``attn_bidir_mlp`` (bidirectional attention + MLP, the
encoder's, full-sequence only), ``attn_cross_mlp`` (causal self-attention,
cross attention over the encoder's output, MLP), ``mamba_mlp`` and
``mamba_moe`` (a Mamba mixer, then an MLP or a MoE), ``mlstm`` and
``slstm`` (an xLSTM mixer alone), for training, prefill and decode.

Weights keep the reference's (d_in, d_out) layout (``x @ wq``) and names,
one sub-layer each (``attn``, ``ln1``, ``xattn``, ``lnx``, ``mamba``,
``mlstm``, ``slstm``, ``mlp``, ``moe``, ``ln2``), so weights carry across
from the reference as copies.  The large projections and the MLP are
``torch.matmul``, as the reference leaves them to XLA; the attention goes
through ``attention.flash_attention`` (the CUDA kernel on the card) when
prefilling and ``decode_attention`` when decoding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..distributed.constraints import as_dtensor, assign_, constrain, rows_map, tp_size

from . import ssm, xlstm
from .attention import decode_attention_flat, flash_attention
from .common import apply_norm, apply_rope, dense_fill_, norm_params
from .moe import MoE

ATTN_KINDS = ("attn_mlp", "attn_moe", "attn_bidir_mlp", "attn_cross_mlp")
# The recurrent kinds: (sub-layer, its weights, prefill, decode).
RECURRENT = {
    "mamba_mlp": ("mamba", ssm.Mamba, ssm.mamba_prefill, ssm.mamba_decode),
    "mamba_moe": ("mamba", ssm.Mamba, ssm.mamba_prefill, ssm.mamba_decode),
    "mlstm": ("mlstm", xlstm.MLSTM, xlstm.mlstm_prefill, xlstm.mlstm_decode),
    "slstm": ("slstm", xlstm.SLSTM, xlstm.slstm_prefill, xlstm.slstm_decode),
}
KINDS = ATTN_KINDS + tuple(RECURRENT)


def check_kind(kind):
    if kind not in KINDS:
        raise ValueError(f"unknown block kind {kind!r}; the kinds are {KINDS}")


def _qkv(cfg, p, x):
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if isinstance(q, DTensor):
        # under a mesh: a flat (heads * hd) dim sharded over "model" in
        # pieces that are not whole heads is gathered before the split
        tp = tp_size() or 1
        rows = ("dp",) + (None,) * (x.ndim - 1)
        q = q if H % tp == 0 else constrain(q, *rows)
        k, v = (k, v) if KV % tp == 0 else (constrain(k, *rows), constrain(v, *rows))
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
    """Second half of a block: the MLP or the MoE over the residual stream.
    ``p`` holds the block's ``mlp`` or ``moe`` and ``ln2``.  Returns (x,
    aux), aux ``{"moe_balance"}`` for a MoE."""
    aux = {}
    if kind.endswith("_moe"):
        b, s, d = x.shape
        y, aux = p["moe"](apply_norm(cfg, x, p["ln2"], "").reshape(b * s, d))
        x = x + y.reshape(b, s, d)
    elif kind.endswith("_mlp"):
        x = x + _mlp(cfg, p["mlp"], apply_norm(cfg, x, p["ln2"], ""))
    return x, aux


def write_row_(cache, pos, row):
    """cache[i, pos[i]] = row[i] for each batch row i, in place; a DTensor
    cache (b, S, D) is written on its own shards."""
    if isinstance(cache, DTensor):
        mesh = cache.device_mesh
        # the row's placements are the cache's with its S dim (never sharded) dropped
        pl = tuple(Shard(p.dim - (p.dim > 1)) if isinstance(p, Shard) else p
                   for p in cache.placements)
        row = as_dtensor(row, mesh).redistribute(mesh, pl).to_local()
        pos = as_dtensor(pos, mesh).redistribute(mesh, tuple(
            p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in cache.placements)).to_local()
        cache = cache.to_local()
    cache[torch.arange(cache.shape[0], device=cache.device), pos] = row
    return cache


def _params(tensors):
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in tensors.items()})


class Block(nn.Module):
    """One layer of ``kind``, its weights allocated uninitialized (biases
    zero, norms ones/zeros, the Mamba constants as the reference makes
    them): ``init_params`` draws them, ``load_state_dict`` loads them
    (``convert.lm_params_from_numpy``).  Every weight is a parameter that
    requires grad."""

    def __init__(self, cfg, kind, *, device=None, dtype=None):
        super().__init__()
        check_kind(kind)
        self.cfg, self.kind = cfg, kind
        dtype = dtype or getattr(torch, cfg.dtype)
        d, H, KV, hd, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff

        def w(*shape):
            return torch.empty(shape, dtype=dtype, device=device)

        def attn(cross):
            p = {"wq": w(d, H * hd), "wk": w(d, KV * hd), "wv": w(d, KV * hd), "wo": w(H * hd, d)}
            if cfg.qkv_bias and not cross:
                p.update({name: torch.zeros((n,), dtype=dtype, device=device)
                          for name, n in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd))})
            return _params(p)

        sub = dict(device=device, dtype=dtype)
        if kind in ATTN_KINDS:
            self.attn = attn(cross=False)
            if kind == "attn_cross_mlp":
                self.xattn = attn(cross=True)
                self.lnx = _params(norm_params(cfg, d, device))
        else:
            name, weights, _, _ = RECURRENT[kind]
            self.add_module(name, weights(cfg, **sub))
        self.ln1 = _params(norm_params(cfg, d, device))
        if kind.endswith("_moe"):
            self.moe = MoE(cfg, **sub)
        elif kind.endswith("_mlp"):
            mlp = {"w_in": w(d, ff), "w_out": w(ff, d)}
            if cfg.mlp == "swiglu":
                mlp["w_gate"] = w(d, ff)
            self.mlp = _params(mlp)
        if kind.endswith(("_moe", "_mlp")):
            self.ln2 = _params(norm_params(cfg, d, device))

    @torch.no_grad()
    def init_params(self, generator):
        """Draw the weights from ``generator`` at the reference's
        ``dense_init`` scale, in the reference's order: the mixer (attn: wq,
        wk, wv, wo; then xattn's), then the MLP (w_in, w_out, w_gate) or
        the MoE."""
        for name in ("attn", "xattn"):
            if hasattr(self, name):
                for w in ("wq", "wk", "wv", "wo"):
                    dense_fill_(getattr(self, name)[w], generator)
        for name in ("mamba", "mlstm", "slstm", "moe"):
            if hasattr(self, name):
                getattr(self, name).init_params(generator)
        if hasattr(self, "mlp"):
            for w in ("w_in", "w_out", "w_gate"):
                if w in self.mlp:
                    dense_fill_(self.mlp[w], generator)
        return self

    def _channel(self):
        return {name: getattr(self, name) for name in ("mlp", "moe", "ln2") if hasattr(self, name)}

    def apply_seq(self, x, positions, *, mode, enc_out=None):
        """Full-sequence path (train/prefill), ``block_apply_seq``.  Returns
        (x, cache, aux).  With ``mode == "prefill"`` the cache holds this
        layer's state for decode: keys and values flat, ``{"k", "v"}: (b, s,
        KV * hd)`` (and the cross attention's ``"xk"``, ``"xv"`` over the
        encoder's length), or the recurrent state after the last token.
        ``enc_out`` (b, s_enc, d): the encoder's output, for
        ``attn_cross_mlp``."""
        cfg, kind = self.cfg, self.kind
        cache = None
        h = apply_norm(cfg, x, self.ln1, "")
        if kind in ATTN_KINDS:
            q, k, v = _qkv(cfg, self.attn, h)
            if cfg.rope:
                q = apply_rope(q, positions, cfg.rope_theta)
                k = apply_rope(k, positions, cfg.rope_theta)
            o = flash_attention(q, k, v, causal=kind != "attn_bidir_mlp", q_chunk=cfg.q_chunk,
                                kv_chunk=cfg.kv_chunk)
            x = x + o.reshape(*x.shape[:-1], -1) @ self.attn["wo"]
            b_, s_ = x.shape[0], x.shape[1]
            if mode == "prefill":
                cache = {"k": k.reshape(b_, s_, -1), "v": v.reshape(b_, s_, -1)}
            if kind == "attn_cross_mlp":
                H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
                hx = apply_norm(cfg, x, self.lnx, "")
                qx = (hx @ self.xattn["wq"]).reshape(*hx.shape[:-1], H, hd)
                kx = (enc_out @ self.xattn["wk"]).reshape(*enc_out.shape[:-1], KV, hd)
                vx = (enc_out @ self.xattn["wv"]).reshape(*enc_out.shape[:-1], KV, hd)
                ox = flash_attention(qx, kx, vx, causal=False, q_chunk=cfg.q_chunk,
                                     kv_chunk=cfg.kv_chunk)
                x = x + ox.reshape(*x.shape[:-1], -1) @ self.xattn["wo"]
                if mode == "prefill":
                    se = enc_out.shape[1]
                    cache.update(xk=kx.reshape(b_, se, -1), xv=vx.reshape(b_, se, -1))
        else:
            name, _, prefill, _ = RECURRENT[kind]
            mixer = getattr(self, name)
            if isinstance(h, DTensor):  # each rank's batch rows, the mixer gathered whole
                y, state = rows_map(lambda hl: prefill(cfg, mixer, hl), mixer, h)
            else:
                y, state = prefill(cfg, mixer, h)
            x = x + y
            if mode == "prefill":
                cache = state
        x, aux = _channel_mix(cfg, kind, self._channel(), x)
        return x, cache, aux

    def apply_decode(self, x, pos, state):
        """One-token path, ``block_apply_decode``.  x: (b, d); pos: (b,);
        state: this layer's cache.  The state is updated in place: the new
        key and value are written into the flat caches ``{"k", "v"}: (b, S,
        KV * hd)`` at ``pos``, and a recurrent state is overwritten by the
        next one (the reference returns updated copies).  The cross
        attention attends over all of ``"xk"``/``"xv"``.  Returns (x,
        state)."""
        cfg, kind = self.cfg, self.kind
        if kind == "attn_bidir_mlp":
            raise ValueError(kind)  # as the reference: no decode without a causal cache
        KV, hd = cfg.n_kv_heads, cfg.hd
        b = x.shape[0]
        h = apply_norm(cfg, x[:, None, :], self.ln1, "")[:, 0]
        if kind in ATTN_KINDS:
            q, k, v = _qkv(cfg, self.attn, h)  # (b, H/KV, hd)
            if cfg.rope:
                q = apply_rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
                k = apply_rope(k[:, None], pos[:, None], cfg.rope_theta)[:, 0]
            write_row_(state["k"], pos, k.reshape(b, -1))
            write_row_(state["v"], pos, v.reshape(b, -1))
            o = decode_attention_flat(q, state["k"], state["v"], pos)
            x = x + o.reshape(b, -1) @ self.attn["wo"]
            if kind == "attn_cross_mlp":
                hx = apply_norm(cfg, x[:, None, :], self.lnx, "")[:, 0]
                qx = (hx @ self.xattn["wq"]).reshape(b, cfg.n_heads, hd)
                s_enc = state["xk"].shape[1]
                ox = decode_attention_flat(qx, state["xk"], state["xv"],
                                           torch.full((b,), s_enc - 1, device=x.device))
                x = x + ox.reshape(b, -1) @ self.xattn["wo"]
        else:
            name, _, _, decode = RECURRENT[kind]
            mixer = getattr(self, name)
            if isinstance(h, DTensor):
                y, new = rows_map(lambda hl, st: decode(cfg, mixer, hl, st), mixer, h, state)
            else:
                y, new = decode(cfg, mixer, h, state)
            x = x + y
            for name, t in new.items():
                assign_(state[name], t)
        if kind.endswith("_moe"):
            hm = apply_norm(cfg, x[:, None, :], self.ln2, "")[:, 0]
            x = x + self.moe(hm, capacity=b)[0]
        elif kind.endswith("_mlp"):
            x = x + _mlp(cfg, self.mlp, apply_norm(cfg, x[:, None, :], self.ln2, "")[:, 0])
        return x, state
