"""Mixture-of-Experts layer (the JAX package's ``models/moe.py``): shared
experts + routed top-k with sort-based capacity dispatch.

Token->expert assignments are sorted by expert id (stably), each gets its
position within its expert, and the tokens are gathered into an (E, C, d)
buffer; an assignment past an expert's capacity C is dropped (weight 0), the
capacity-factor policy.  The combine is a gather and a weighted sum over the
k assignments of each token, as in the reference.

This is the reference's single-device path (``_moe_apply_gspmd``), which it
runs outside a mesh.  Its expert-parallel ``shard_map`` path belongs to the
port of ``distributed/`` (ROADMAP A-17) and is not here.  The expert
products are ``torch.bmm``, as the reference leaves its einsums to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import Params


class MoE(Params):
    """A MoE layer's weights (``moe_params``): ``router`` (d, E) in float32,
    ``w_in`` and ``w_gate`` (E, d, h), ``w_out`` (E, h, d), and with
    ``n_shared > 0`` the shared experts' ``shared_in``, ``shared_gate`` (d,
    n_shared h) and ``shared_out`` (n_shared h, d).  Calling it applies
    ``moe_apply``."""

    dense = ("router", "w_in", "w_gate", "w_out", "shared_in", "shared_gate", "shared_out")

    def __init__(self, cfg, *, device=None, dtype=None):
        m = cfg.moe
        d, e, h = cfg.d_model, m.n_experts, m.d_expert
        dtype = dtype or getattr(torch, cfg.dtype)

        def w(*shape, dt=dtype):
            return torch.empty(shape, dtype=dt, device=device)

        p = {"router": w(d, e, dt=torch.float32), "w_in": w(e, d, h), "w_gate": w(e, d, h),
             "w_out": w(e, h, d)}
        if m.n_shared > 0:
            hs = m.n_shared * h
            p.update(shared_in=w(d, hs), shared_gate=w(d, hs), shared_out=w(hs, d))
        super().__init__(p)
        self.cfg = cfg

    def forward(self, x, capacity=None):
        return moe_apply(self.cfg, self, x, capacity)


def expert_capacity(cfg, T):
    """Slots per expert for T tokens: max(1, int(cf k T / E)), as the
    reference computes it in Python."""
    m = cfg.moe
    return max(1, int(m.capacity_factor * m.top_k * T / m.n_experts))


def route(cfg, p, x):
    """The router: (probs (T, E) float32, topw (T, k) renormalized, topi (T,
    k)).  The top k of a stable descending sort, so that of equal
    probabilities the lower expert comes first, as ``jax.lax.top_k`` orders
    them."""
    k = cfg.moe.top_k
    # the router product in x's dtype, the softmax in float32 (the reference's)
    logits = (x @ p["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :k], topi[:, :k]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    return probs, topw, topi


def moe_apply(cfg, p, x, capacity=None):
    """x: (T, d) tokens; returns ((T, d), {"moe_balance": Switch load-balance
    loss}).  ``capacity`` overrides the capacity-factor policy; decode passes
    T, so that a step can never drop."""
    m = cfg.moe
    T, d = x.shape
    E, k = m.n_experts, m.top_k
    C = capacity if capacity is not None else expert_capacity(cfg, T)
    dev = x.device

    probs, topw, topi = route(cfg, p, x)

    # --- sort-based position within expert ---------------------------------
    flat_e = topi.reshape(-1)  # (T*k,), entry j belongs to token j // k
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(sorted_e, torch.arange(E, device=dev), side="left")
    pos_sorted = torch.arange(T * k, device=dev) - seg_start[sorted_e]
    slot_sorted = torch.where(pos_sorted < C, sorted_e * C + pos_sorted, E * C)

    # buffer slot -> sorted index; every dropped entry writes the extra slot
    # E*C, which is never read
    inv = torch.zeros(E * C + 1, dtype=torch.long, device=dev)
    inv[slot_sorted] = torch.arange(T * k, device=dev)
    counts = torch.diff(torch.cat([seg_start, seg_start.new_full((1,), T * k)]))
    valid = torch.arange(C, device=dev)[None, :] < torch.clamp(counts, max=C)[:, None]
    src_tok = order[inv[:E * C]] // k  # (E*C,) source token per buffer slot
    xe = x[src_tok].reshape(E, C, d) * valid[..., None].to(x.dtype)

    # --- experts -------------------------------------------------------------
    h = torch.bmm(xe, p["w_in"])
    g = torch.bmm(xe, p["w_gate"])
    ye = torch.bmm(F.silu(g) * h, p["w_out"])  # (E, C, d)

    # --- combine: gather each assignment's row, weighted sum over k ---------
    slot_flat = torch.empty(T * k, dtype=torch.long, device=dev)
    slot_flat[order] = slot_sorted
    kept = slot_flat < E * C
    rows = ye.reshape(E * C, d)[torch.clamp(slot_flat, max=E * C - 1)]
    w = (topw.reshape(-1) * kept).to(x.dtype)
    out = torch.sum(rows.reshape(T, k, d) * w.reshape(T, k, 1), dim=1)

    if m.n_shared > 0:
        out = out + (F.silu(x @ p["shared_gate"]) * (x @ p["shared_in"])) @ p["shared_out"]

    # Switch load-balance loss.  ce sums each expert's weights through a
    # one-hot product, in a fixed order (index_add_ sums in any order on the
    # card).
    me = probs.mean(0)
    hot = (topi[..., None] == torch.arange(E, device=dev)).to(topw.dtype)  # (T, k, E)
    ce = torch.einsum("tke,tk->e", hot, topw) / T
    return out, {"moe_balance": E * torch.sum(me * ce)}
