"""xLSTM blocks (the JAX package's ``models/xlstm.py``): mLSTM (matrix
memory, chunkwise-parallel) and sLSTM (scalar memory, a sequential
recurrence).

mLSTM trains and prefills in the reference's chunkwise-recurrent form:
within a chunk a decay-weighted quadratic form, across chunks a (hd x hd)
matrix state carried in a loop, every exponential stabilized by the running
log-magnitude m.  sLSTM's gates depend on h_{t-1}, so it runs token by
token; the input half of its gate preactivations (x_t @ W) does not, and is
one product over all tokens before the loop (the four W's and the four R's
each concatenated), the same arithmetic as the reference's cell to
rounding.  Both decode with an O(1) state.  ``mlstm_prefill`` and
``slstm_prefill`` return the forward's output and its final carry, the
state the reference recomputes token by token in
``_mlstm_state_from_seq`` / ``_slstm_state_from_seq`` (for mLSTM the
chunk carry equals the token recursion's state in exact arithmetic).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import Params, log_sigmoid

NEG = -1e30


# ----------------------------------------------------------------- mLSTM


class MLSTM(Params):
    """An mLSTM block's weights (``mlstm_params``): ``up`` (d, dp), ``wq``,
    ``wk``, ``wv``, ``wo`` (dp, dp), ``down`` (dp, d) in the model's dtype;
    the gate projections ``wi``, ``wf`` (dp, H) in float32; dp =
    ``xlstm_proj`` d."""

    dense = ("up", "wq", "wk", "wv", "wi", "wf", "wo", "down")

    def __init__(self, cfg, *, device=None, dtype=None):
        d, H = cfg.d_model, cfg.n_heads
        dp = cfg.xlstm_proj * d
        dtype = dtype or getattr(torch, cfg.dtype)

        def w(*shape, dt=dtype):
            return torch.empty(shape, dtype=dt, device=device)

        super().__init__({"up": w(d, dp), "wq": w(dp, dp), "wk": w(dp, dp), "wv": w(dp, dp),
                          "wi": w(dp, H, dt=torch.float32), "wf": w(dp, H, dt=torch.float32),
                          "wo": w(dp, dp), "down": w(dp, d)})


def _mlstm_qkvif(cfg, p, x):
    H = cfg.n_heads
    up = x @ p["up"]  # (..., dp)
    hd = up.shape[-1] // H
    q = (up @ p["wq"]).reshape(*up.shape[:-1], H, hd)
    k = (up @ p["wk"]).reshape(*up.shape[:-1], H, hd) / math.sqrt(float(hd))
    v = (up @ p["wv"]).reshape(*up.shape[:-1], H, hd)
    li = up.float() @ p["wi"]  # log input gate preactivation (..., H)
    lf = log_sigmoid(up.float() @ p["wf"])  # log forget gate (..., H)
    return up, q, k, v, li, lf


def _mlstm_seq(cfg, p, x, chunk):
    b, s, _ = x.shape
    H = cfg.n_heads
    L = min(chunk, s)
    assert s % L == 0
    nC = s // L

    up, q, k, v, li, lf = _mlstm_qkvif(cfg, p, x)
    hd = q.shape[-1]

    def chunked(t):  # (b, s, H, hd) -> (nC, b, H, L, hd)
        return t.reshape(b, nC, L, H, hd).permute(1, 0, 3, 2, 4).float()

    qc, kc, vc = chunked(q), chunked(k), chunked(v)
    lic = li.reshape(b, nC, L, H).permute(1, 0, 3, 2)  # (nC, b, H, L)
    lfc = lf.reshape(b, nC, L, H).permute(1, 0, 3, 2)

    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    C = x.new_zeros((b, H, hd, hd), dtype=torch.float32)
    n = x.new_zeros((b, H, hd), dtype=torch.float32)
    m = x.new_full((b, H), NEG, dtype=torch.float32)
    hs = []
    for j in range(nC):
        qj, kj, vj, lij, lfj = qc[j], kc[j], vc[j], lic[j], lfc[j]
        cum = torch.cumsum(lfj, dim=-1)  # (b, H, L) inclusive decay from the chunk start
        # g[t, j] = cum_t - cum_j + li_j: the decay of contribution j at time t
        g = cum[..., :, None] - cum[..., None, :] + lij[..., None, :]
        g = torch.where(tri, g, NEG)
        m_inter = cum + m[..., None]  # (b, H, L): log-magnitude of the inter-chunk path
        m_t = torch.maximum(g.amax(dim=-1), m_inter)

        S = torch.exp(g - m_t[..., None])  # (b, H, L, L)
        qk = torch.einsum("bhte,bhje->bhtj", qj, kj)
        inter = torch.exp(m_inter - m_t)[..., None]
        num = torch.einsum("bhtj,bhjv->bhtv", S * qk, vj)
        num = num + inter * torch.einsum("bhte,bhev->bhtv", qj, C)
        den_vec = torch.einsum("bhtj,bhje->bhte", S, kj) + inter * n[..., None, :]
        den = torch.abs(torch.einsum("bhte,bhte->bht", qj, den_vec))
        den = torch.maximum(den, torch.exp(-m_t))
        hs.append(num / den[..., None])  # (b, H, L, hd)

        # the state carried to the chunk's end
        cum_L = cum[..., -1]  # (b, H)
        gk = cum_L[..., None] - cum + lij  # (b, H, L): decay of j to the chunk's end
        m_new = torch.maximum(cum_L + m, gk.amax(dim=-1))
        wgt = torch.exp(gk - m_new[..., None])  # (b, H, L)
        carry = torch.exp(cum_L + m - m_new)
        C = carry[..., None, None] * C + torch.einsum("bhje,bhjv->bhev", wgt[..., None] * kj, vj)
        n = carry[..., None] * n + torch.einsum("bhj,bhje->bhe", wgt, kj)
        m = m_new

    # (nC, b, H, L, hd) -> (b, s, dp)
    h = torch.stack(hs).permute(1, 0, 3, 2, 4).reshape(b, s, H * hd).to(x.dtype)
    out = h * F.silu(up @ p["wo"])
    return out @ p["down"], {"C": C, "n": n, "m": m}


def mlstm_forward(cfg, p, x, chunk=256):
    """x: (b, s, d) -> (b, s, d), chunkwise-parallel; s a multiple of
    min(chunk, s), as the reference asserts."""
    return _mlstm_seq(cfg, p, x, chunk)[0]


def mlstm_prefill(cfg, p, x, chunk=256):
    """``mlstm_forward`` and the state after the last token, ``{"C", "n",
    "m"}`` in float32: the last chunk's carry."""
    return _mlstm_seq(cfg, p, x, chunk)


def mlstm_init_state(cfg, batch, device=None):
    H = cfg.n_heads
    hd = cfg.xlstm_proj * cfg.d_model // H
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, H, hd, hd), **f32), "n": torch.zeros((batch, H, hd), **f32),
            "m": torch.full((batch, H), NEG, **f32)}


def mlstm_decode(cfg, p, x, state):
    """x: (b, d) one token; returns (y (b, d), the new state)."""
    up, q, k, v, li, lf = _mlstm_qkvif(cfg, p, x)  # (b, H, hd) / (b, H)
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(lf + m, li)
    fw = torch.exp(lf + m - m_new)[..., None]
    iw = torch.exp(li - m_new)[..., None]
    qf, kf, vf = q.float(), k.float(), v.float()
    C_new = fw[..., None] * C + iw[..., None] * torch.einsum("bhe,bhv->bhev", kf, vf)
    n_new = fw * n + iw * kf
    num = torch.einsum("bhe,bhev->bhv", qf, C_new)
    den = torch.maximum(torch.abs(torch.einsum("bhe,bhe->bh", qf, n_new)), torch.exp(-m_new))
    h = (num / den[..., None]).reshape(x.shape[0], -1).to(x.dtype)
    out = h * F.silu(up @ p["wo"])
    return out @ p["down"], {"C": C_new, "n": n_new, "m": m_new}


# ----------------------------------------------------------------- sLSTM


class SLSTM(Params):
    """An sLSTM block's weights (``slstm_params``): the recurrent ``r_z``,
    ``r_i``, ``r_f``, ``r_o``, the input ``w_z``, ``w_i``, ``w_f``, ``w_o``
    and ``out``, each (d, d)."""

    dense = tuple("r_" + g for g in "zifo") + tuple("w_" + g for g in "zifo") + ("out",)

    def __init__(self, cfg, *, device=None, dtype=None):
        d = cfg.d_model
        dtype = dtype or getattr(torch, cfg.dtype)
        super().__init__({name: torch.empty((d, d), dtype=dtype, device=device)
                          for name in self.dense})


def slstm_init_state(cfg, batch, dtype=None, device=None):
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, d), **f32), "n": torch.zeros((batch, d), **f32),
            "h": torch.zeros((batch, d), **f32), "m": torch.full((batch, d), NEG, **f32)}


def _slstm_weights(p):
    """(W, R): the input and recurrent projections of the gates z, i, f, o
    side by side, (d, 4d) float32 each."""
    return (torch.cat([p["w_" + g] for g in "zifo"], dim=1).float(),
            torch.cat([p["r_" + g] for g in "zifo"], dim=1).float())


def _slstm_update(pre, st):
    """The cell from its gate preactivations pre = x_t W + h_{t-1} R (b,
    4d) and the state ``st``; returns the new state."""
    z, i, f, o = torch.chunk(pre, 4, dim=-1)
    zt, ot, lf = torch.tanh(z), torch.sigmoid(o), log_sigmoid(f)
    m_new = torch.maximum(lf + st["m"], i)
    iw = torch.exp(i - m_new)
    fw = torch.exp(lf + st["m"] - m_new)
    c = fw * st["c"] + iw * zt
    n = torch.maximum(fw * st["n"] + iw, torch.exp(-m_new))
    return {"c": c, "n": n, "h": ot * c / n, "m": m_new}


def _slstm_cell(p, xt, st):
    """xt: (b, d) float32 gate inputs; st: the state dict."""
    W, R = _slstm_weights(p)
    return _slstm_update(xt @ W + st["h"] @ R, st)


def _slstm_seq(cfg, p, x):
    b, s, _ = x.shape
    W, R = _slstm_weights(p)
    pre_x = x.float() @ W  # (b, s, 4d): the half of the gates that does not wait on h
    st = slstm_init_state(cfg, b, device=x.device)
    hs = []
    for t in range(s):
        st = _slstm_update(torch.addmm(pre_x[:, t], st["h"], R), st)
        hs.append(st["h"])
    h = torch.stack(hs, dim=1).to(x.dtype)
    return h @ p["out"], st


def slstm_forward(cfg, p, x):
    """x: (b, s, d) -> (b, s, d); token by token."""
    return _slstm_seq(cfg, p, x)[0]


def slstm_prefill(cfg, p, x):
    """``slstm_forward`` and the state after the last token, ``{"c", "n",
    "h", "m"}`` in float32."""
    return _slstm_seq(cfg, p, x)


def slstm_decode(cfg, p, x, state):
    st = _slstm_cell(p, x.float(), state)
    return st["h"].to(x.dtype) @ p["out"], st
