"""Mixture-of-Experts layer (the JAX package's ``models/moe.py``): shared
experts + routed top-k with sort-based capacity dispatch.

Token->expert assignments are sorted by expert id (stably), each gets its
position within its expert, and the tokens are gathered into an (E, C, d)
buffer; an assignment past an expert's capacity C is dropped (weight 0), the
capacity-factor policy.  The combine is a gather and a weighted sum over the
k assignments of each token, as in the reference.

Outside a mesh this is the reference's single-device path
(``_moe_apply_gspmd``).  Under a mesh (DTensor tokens inside
``activation_sharding``) with the experts dividing by the model dim, it is
the reference's expert-parallel path (``_moe_apply_shardmap``) through
``local_map``: tokens sharded over the data dims and replicated over
"model", each rank holding E / tp experts; every rank routes its tokens,
serves the assignments of its own experts at a capacity per data shard,
and the partial outputs are summed by ONE reduction over "model" (a
``Partial()`` output).  Decode (and any caller that passes ``capacity``)
and a mesh the experts do not divide run the single-device path on the
gathered tokens.  The expert products are ``torch.bmm``, as the reference
leaves its einsums to XLA.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..distributed.constraints import current_mesh, logical_axes, replicated, resolve
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
    T, so that a step can never drop.  Under a mesh the expert-parallel
    path (module docstring)."""
    mesh = current_mesh()
    if isinstance(x, DTensor) and mesh is not None:
        names = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        dp_ax = tuple(a for a in (logical_axes()[0] or ()) if a in names)
        dp_size = math.prod(names[a] for a in dp_ax)
        T = x.shape[0]
        if (capacity is None and "model" in names and cfg.moe.n_experts % names["model"] == 0
                and T % dp_size == 0 and T // dp_size >= 1):
            return moe_apply_expert_parallel(cfg, p, x, mesh)
        return _moe_apply_gathered(cfg, p, x, capacity, mesh)
    return _moe_apply_single(cfg, p, x, capacity)


def _moe_apply_gathered(cfg, p, x, capacity, mesh):
    """The single-device path on every rank over all tokens and the whole
    weights (each rank computes the same, so every gradient is whole)."""
    rep = replicated(mesh)
    names = [n for n in MoE.dense if n in p]
    local = local_map(lambda xl, *ws: _moe_apply_single(cfg, dict(zip(names, ws)), xl, capacity),
                      out_placements=(rep, rep), in_placements=(rep,) * (1 + len(names)),
                      device_mesh=mesh, redistribute_inputs=True)
    out, aux = local(x, *(p[n] for n in names))
    return out, {"moe_balance": aux["moe_balance"]}


def moe_apply_expert_parallel(cfg, p, x, mesh):
    """The reference's ``_moe_apply_shardmap``: tokens (T, d) sharded over
    the data dims, experts over "model".  Each rank routes its T_loc tokens
    (the router whole), keeps the assignments to its E_loc = E / tp experts
    (the rest go to the drop bucket E_loc, the stable order kept), fills
    them to C = max(1, int(cf k T_loc / E)) slots an expert, and returns
    its partial combined output; the sum over "model" is the DTensor's
    ``Partial()`` placement.  The balance loss is each data shard's,
    averaged over the data dims.  The shared experts run outside, on the
    DTensors."""
    m = cfg.moe
    T, d = x.shape
    E, k = m.n_experts, m.top_k
    tp = mesh.get_group("model").size()
    E_loc = E // tp
    dp_size = math.prod(mesh.get_group(a).size() for a in mesh.mesh_dim_names if a != "model")
    T_loc = T // dp_size
    C = max(1, int(m.capacity_factor * k * T_loc / E))
    midx = mesh.get_local_rank("model")

    def local_fn(x_loc, router, w_in, w_gate, w_out):
        dev = x_loc.device
        probs, topw, topi = route(cfg, {"router": router}, x_loc)
        flat_e = topi.reshape(-1)  # (T_loc*k,) global expert ids
        le = flat_e - midx * E_loc
        is_local = (le >= 0) & (le < E_loc)
        le = torch.where(is_local, le, E_loc)  # E_loc = the drop bucket

        order = torch.argsort(le, stable=True)
        sorted_e = le[order]
        seg_start = torch.searchsorted(sorted_e, torch.arange(E_loc, device=dev), side="left")
        pos_sorted = torch.arange(T_loc * k, device=dev) - seg_start[
            torch.clamp(sorted_e, max=E_loc - 1)]
        keep = (pos_sorted < C) & (sorted_e < E_loc)
        slot_sorted = torch.where(keep, sorted_e * C + pos_sorted, E_loc * C)

        inv = torch.zeros(E_loc * C + 1, dtype=torch.long, device=dev)
        inv[slot_sorted] = torch.arange(T_loc * k, device=dev)
        counts = torch.diff(torch.cat([seg_start, seg_start.new_full((1,), T_loc * k)]))
        valid = torch.arange(C, device=dev)[None, :] < torch.clamp(counts, max=C)[:, None]
        src_tok = order[inv[:E_loc * C]] // k
        xe = x_loc[src_tok].reshape(E_loc, C, d) * valid[..., None].to(x_loc.dtype)

        h = torch.bmm(xe, w_in)
        g = torch.bmm(xe, w_gate)
        ye = torch.bmm(F.silu(g) * h, w_out)

        slot_flat = torch.empty(T_loc * k, dtype=torch.long, device=dev)
        slot_flat[order] = slot_sorted
        kept = slot_flat < E_loc * C
        rows = ye.reshape(E_loc * C, d)[torch.clamp(slot_flat, max=E_loc * C - 1)]
        w = (topw.reshape(-1) * kept).to(x_loc.dtype)
        part = torch.sum(rows.reshape(T_loc, k, d) * w.reshape(T_loc, k, 1), dim=1)

        aux = balance_loss(probs, topw, topi, E) / dp_size
        if midx != 0:
            # every model rank computes the same loss: its gradient is taken
            # once, so that the router's and the tokens' gradients (partial
            # sums over "model") count it once
            aux = aux.detach()
        return part, aux

    names = mesh.mesh_dim_names
    tok = resolve(mesh, "dp", None, shape=x.shape)
    tok_grad = tuple(Partial() if n == "model" else pl for n, pl in zip(names, tok))
    experts = tuple(Shard(0) if n == "model" else Replicate() for n in names)
    summed = tuple(Partial() if n != "model" else pl for n, pl in zip(names, experts))
    router_pl = replicated(mesh)
    out_pl = tuple(Partial() if n == "model" else pl for n, pl in zip(names, tok))
    aux_pl = tuple(Partial() if n != "model" else Replicate() for n in names)
    out, aux = local_map(
        local_fn, out_placements=(out_pl, aux_pl),
        in_placements=(tok, router_pl, experts, experts, experts),
        in_grad_placements=(tok_grad, tuple(Partial() for _ in names), summed, summed, summed),
        device_mesh=mesh, redistribute_inputs=True,
    )(x, p["router"], p["w_in"], p["w_gate"], p["w_out"])
    out = out.redistribute(mesh, tok)  # the one reduction over "model"
    if m.n_shared > 0:
        out = out + (F.silu(x @ p["shared_gate"]) * (x @ p["shared_in"])) @ p["shared_out"]
    return out, {"moe_balance": aux.redistribute(mesh, router_pl)}


def balance_loss(probs, topw, topi, E):
    """The Switch load-balance loss E * sum(me * ce).  ce sums each expert's
    weights through a one-hot product, in a fixed order (index_add_ sums in
    any order on the card)."""
    me = probs.mean(0)
    hot = (topi[..., None] == torch.arange(E, device=topi.device)).to(topw.dtype)  # (T, k, E)
    ce = torch.einsum("tke,tk->e", hot, topw) / topi.shape[0]
    return E * torch.sum(me * ce)


def _moe_apply_single(cfg, p, x, capacity=None):
    """The reference's ``_moe_apply_gspmd`` on plain tensors."""
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

    return out, {"moe_balance": balance_loss(probs, topw, topi, E)}
