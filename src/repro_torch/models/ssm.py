"""Mamba selective-SSM block, jamba's sequence mixer (the JAX package's
``models/ssm.py``).

The recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t has a diagonal
transition.  The reference evaluates it over the whole sequence with one
``lax.associative_scan``, whose elements are (b, s, d_inner, N) float32:
2.1 GB each at jamba's width and a prompt of 2048.  Here the scan runs in
chunks of ``SCAN_CHUNK`` tokens along s, carrying h from one chunk to the
next; within a chunk it is the same associative combine in log2(chunk)
doubling steps (Hillis-Steele), so that no tensor holds more than one chunk
of (b, chunk, d_inner, N).  The summation order differs from
``associative_scan``'s; the arithmetic is the same to rounding.

Decode carries (h, conv window) and costs O(1) a token.  ``mamba_prefill``
returns the forward's output and its final carry, the state the reference
recomputes in ``_mamba_state_from_seq``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import Params, softplus

SCAN_CHUNK = 128


class Mamba(Params):
    """A Mamba block's weights (``mamba_params``): ``in_proj`` (d, 2 di),
    ``conv_w`` (K, di), ``conv_b`` zeros, ``x_proj`` (di, R + 2N),
    ``dt_proj`` (R, di), ``out_proj`` (di, d) in the model's dtype;
    ``dt_bias`` zeros, ``A_log`` = log(1..N) on every row and ``D`` ones in
    float32, as the reference makes them."""

    dense = ("in_proj", "conv_w", "x_proj", "dt_proj", "out_proj")

    def __init__(self, cfg, *, device=None, dtype=None):
        d, di, N, R, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank_, cfg.ssm_conv
        dtype = dtype or getattr(torch, cfg.dtype)

        def w(*shape):
            return torch.empty(shape, dtype=dtype, device=device)

        f32 = dict(dtype=torch.float32, device=device)
        super().__init__({
            "in_proj": w(d, 2 * di),
            "conv_w": w(K, di),
            "conv_b": torch.zeros((di,), dtype=dtype, device=device),
            "x_proj": w(di, R + 2 * N),
            "dt_proj": w(R, di),
            "dt_bias": torch.zeros((di,), **f32),
            "A_log": torch.arange(1, N + 1, **f32).log().expand(di, N).contiguous(),
            "D": torch.ones((di,), **f32),
            "out_proj": w(di, d),
        })


def _dt_b_c(cfg, p, u):
    N, R = cfg.ssm_state, cfg.dt_rank_
    dbc = u @ p["x_proj"]  # (..., R + 2N)
    dt = softplus(dbc[..., :R] @ p["dt_proj"] + p["dt_bias"].to(dbc.dtype)).float()
    B = dbc[..., R:R + N].float()
    C = dbc[..., R + N:].float()
    return dt, B, C


def _causal_conv(p, u, K):
    """u: (b, s, di); depthwise causal conv of width K, summed over i = 0..K-1
    in order, as the reference sums it."""
    s = u.shape[1]
    pad = F.pad(u, (0, 0, K - 1, 0))
    out = pad[:, 0:s, :] * p["conv_w"][0]
    for i in range(1, K):
        out = out + pad[:, i:i + s, :] * p["conv_w"][i]
    return F.silu(out + p["conv_b"])


def _scan(dt, A, B, C, uf, chunk=SCAN_CHUNK):
    """y_t = C_t . h_t for h_t = exp(dt_t A) h_{t-1} + dt_t u_t B_t, h_0 = 0,
    chunk by chunk.  dt, uf: (b, s, di); A: (di, N); B, C: (b, s, N).
    Returns (y (b, s, di), h at the last token (b, di, N)), float32."""
    b, s, di = dt.shape
    h = dt.new_zeros((b, di, A.shape[-1]))
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        a = torch.exp(dt[:, sl, :, None] * A)  # (b, L, di, N)
        bu = (dt[:, sl] * uf[:, sl])[..., None] * B[:, sl, None, :]
        L, off = a.shape[1], 1
        # inclusive scan of (a, bu) under (al, bl) . (ar, br) = (al ar, bl ar + br)
        while off < L:
            bu = torch.cat([bu[:, :off], bu[:, :-off] * a[:, off:] + bu[:, off:]], dim=1)
            a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1)
            off *= 2
        hs = bu + a * h[:, None]  # the carry enters through the chunk's products
        ys.append(torch.einsum("bsdn,bsn->bsd", hs, C[:, sl]))
        h = hs[:, -1]
    return torch.cat(ys, dim=1), h


def _mamba_seq(cfg, p, x):
    A = -torch.exp(p["A_log"])  # (di, N)
    xi, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)
    u = _causal_conv(p, xi, cfg.ssm_conv)  # (b, s, di)
    dt, B, C = _dt_b_c(cfg, p, u)
    uf = u.float()
    y, h = _scan(dt, A, B, C, uf)
    y = y + uf * p["D"]
    y = y.to(x.dtype) * F.silu(z)
    return y @ p["out_proj"], xi, h


def mamba_forward(cfg, p, x):
    """The parallel (training/prefill) path.  x: (b, s, d) -> (b, s, d)."""
    return _mamba_seq(cfg, p, x)[0]


def mamba_prefill(cfg, p, x):
    """``mamba_forward`` and the state after the last token: ``{"h": (b, di,
    N) float32, "conv": the last K - 1 conv inputs (b, K - 1, di)}`` (zero
    rows before the first token where s < K - 1)."""
    K = cfg.ssm_conv
    y, xi, h = _mamba_seq(cfg, p, x)
    padded = F.pad(xi, (0, 0, K - 1, 0))
    conv = padded[:, padded.shape[1] - (K - 1):]
    return y, {"h": h, "conv": conv}


def mamba_init_state(cfg, batch, dtype, device=None):
    di, N, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return {
        "h": torch.zeros((batch, di, N), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, K - 1, di), dtype=dtype, device=device),
    }


def mamba_decode(cfg, p, x, state):
    """One-token step.  x: (b, d) -> (b, d); returns (y, the new state)."""
    N, R = cfg.ssm_state, cfg.dt_rank_
    A = -torch.exp(p["A_log"])
    xi, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)  # (b, di)

    win = torch.cat([state["conv"], xi[:, None, :]], dim=1)  # (b, K, di)
    u = F.silu(torch.einsum("bkd,kd->bd", win, p["conv_w"]) + p["conv_b"])

    dbc = u @ p["x_proj"]
    dt = softplus(dbc[..., :R] @ p["dt_proj"] + p["dt_bias"].to(dbc.dtype)).float()
    B = dbc[..., R:R + N].float()
    C = dbc[..., R + N:].float()

    uf = u.float()
    dA = torch.exp(dt[..., None] * A)  # (b, di, N)
    h = state["h"] * dA + (dt * uf)[..., None] * B[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, C) + uf * p["D"]
    y = y.to(x.dtype) * F.silu(z)
    return y @ p["out_proj"], {"h": h, "conv": win[:, 1:, :]}
