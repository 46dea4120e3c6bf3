"""Sharding rules for parameters, optimizer state, activations and caches
(the JAX package's ``distributed/sharding.py``), as DTensor placements.

Layout summary (mesh dims: optional "pod", "data", "model"):
  - batch dims           -> ("pod", "data")   [dp]
  - attention heads/ffn  -> "model"           [tensor parallelism]
  - MoE expert dim       -> "model"           [expert parallelism]
  - vocab (embed rows)   -> "model"
  - FSDP: the non-model weight dim additionally shards over dp (ZeRO-3);
    optimizer moments inherit their parameter's spec.
  - KV caches: flat head dim (KV*hd) -> "model"; batch -> dp.

Every rule is guarded by divisibility: a dim that does not divide evenly by
the axis size falls back to replication.

The rules compute a *logical* spec first, the reference's ``PartitionSpec``
as a tuple with one entry per tensor dim (None, an axis name, or a tuple of
axis names), and turn it into a *placement* spec, a tuple with one DTensor
placement per mesh dim (``Shard(dim)`` or ``Replicate()``); ``to_logical``
turns it back.  A dim sharded over two mesh dims ("pod", "data") is split
in mesh-dim order, pod major, as GSPMD splits it.

``mesh`` is a ``DeviceMesh`` with named dims, or any mapping of dim names to
sizes in mesh order (``{"data": 2, "model": 4}``): the rules are pure
functions of shapes and need no process group.  The port's parameters are
per layer (``blocks.{layer}.attn.wq``), where the reference's carry a
leading period axis; the rule of a layer's leaf is the reference's with
that axis dropped.  The caches keep the period axis, as the reference's.
"""

from __future__ import annotations

from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor


def mesh_axes(mesh) -> dict:
    """{dim name: size} of ``mesh`` in mesh order."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(mesh)


def dp_axes(mesh) -> tuple:
    names = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _axis_size(mesh, axis):
    if axis is None:
        return 1
    names = mesh_axes(mesh)
    if isinstance(axis, tuple):
        s = 1
        for a in axis:
            s *= names[a]
        return s
    return names[axis]


def _guard(mesh, shape, spec):
    """Replace any axis assignment whose shard count does not divide the dim."""
    return tuple(axis if dim % _axis_size(mesh, axis) == 0 else None
                 for dim, axis in zip(shape, spec))


def to_placements(mesh, logical) -> tuple:
    """The placement spec (one per mesh dim) of a logical spec (one entry
    per tensor dim)."""
    out = []
    for name in mesh_axes(mesh):
        dims = [d for d, axis in enumerate(logical)
                if axis == name or (isinstance(axis, tuple) and name in axis)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def to_logical(mesh, placements, ndim: int) -> tuple:
    """The logical spec of a placement spec, each entry normalized to a
    tuple of axis names (``()`` for a replicated dim), for comparison with
    the reference's ``PartitionSpec``."""
    axes = [[] for _ in range(ndim)]
    for name, pl in zip(mesh_axes(mesh), placements):
        if isinstance(pl, Shard):
            axes[pl.dim].append(name)
    return tuple(tuple(a) for a in axes)


def _leaf_name(path):
    parts = path.split(".") if isinstance(path, str) else list(path)
    name = parts[-1]
    # quantized-optimizer leaves ("q" int8 payload / "s" blockwise scales)
    # inherit their parameter's rule; see optim/quantized.py
    if name in ("q", "s") and len(parts) >= 2:
        name = parts[-2]
    return name, parts


def _weight_rule(name: str, parts: list[str], ndim: int, fsdp_ax):
    moe = "moe" in parts
    table = {
        "embed": ("model", fsdp_ax),
        "wq": (fsdp_ax, "model"),
        "wk": (fsdp_ax, "model"),
        "wv": (fsdp_ax, "model"),
        "wo": ("model", fsdp_ax),
        "bq": ("model",),
        "bk": ("model",),
        "bv": ("model",),
        "router": (fsdp_ax, None),
        "shared_in": (fsdp_ax, "model"),
        "shared_gate": (fsdp_ax, "model"),
        "shared_out": ("model", fsdp_ax),
        # mamba
        "in_proj": (fsdp_ax, "model"),
        "conv_w": (None, "model"),
        "conv_b": ("model",),
        "x_proj": ("model", None),
        "dt_proj": (None, "model"),
        "dt_bias": ("model",),
        "A_log": ("model", None),
        "D": ("model",),
        "out_proj": ("model", fsdp_ax),
        # xlstm
        "up": (fsdp_ax, "model"),
        "down": ("model", fsdp_ax),
        "wi": (None, None),
        "wf": (None, None),
        "out": (None, "model"),
    }
    if moe and name in ("w_in", "w_gate"):
        return ("model", fsdp_ax, None)  # (E, d, h): expert parallel + fsdp
    if moe and name == "w_out":
        return ("model", None, fsdp_ax)
    if name in ("w_in", "w_gate"):
        return (fsdp_ax, "model")
    if name == "w_out":
        return ("model", fsdp_ax)
    if name.startswith("r_") or name.startswith("w_"):  # slstm gates
        return (None, "model")
    if name.endswith("_scale") or name.endswith("_bias"):
        return (None,) * ndim
    if name in table:
        return table[name]
    return (None,) * ndim


def _named_leaves(tree, prefix=""):
    """(dotted name, leaf) of a module's parameters or a nested dict."""
    if hasattr(tree, "named_parameters"):
        yield from tree.named_parameters()
        return
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _named_leaves(v, name)
        else:
            yield name, v


def _nest(flat):
    """{"a.b.q": x} -> {"a.b": {"q": x}} for the 8-bit moments' leaves."""
    out = {}
    for name, x in flat.items():
        head, _, last = name.rpartition(".")
        if last in ("q", "s") and head:
            out.setdefault(head, {})[last] = x
        else:
            out[name] = x
    return out


def param_logical(mesh, name: str, shape, *, fsdp: bool = True) -> tuple:
    """The reference's ``PartitionSpec`` of the port's leaf ``name`` of
    ``shape`` (a parameter, or a moment's ``name.q`` / ``name.s``)."""
    fs = dp_axes(mesh) if fsdp else None
    if fs is not None and len(fs) == 1:
        fs = fs[0]
    leaf, parts = _leaf_name(name)
    ndim = len(shape)
    rule = _weight_rule(leaf, parts, ndim, fs)
    rule = (tuple(rule) + (None,) * ndim)[:ndim]
    return _guard(mesh, shape, rule)


def param_shardings(mesh, abstract_params, *, fsdp: bool = True):
    """{name: placement spec} of a parameters (or AdamW moments) tree: an
    ``LM`` (``launch.specs.abstract_params`` on the meta device, or a live
    one) or a dict by name (8-bit moments ``{name: {"q", "s"}}``)."""
    flat = {name: to_placements(mesh, param_logical(mesh, name, leaf.shape, fsdp=fsdp))
            for name, leaf in _named_leaves(abstract_params)}
    return _nest(flat) if not hasattr(abstract_params, "named_parameters") else flat


def state_shardings(mesh, abstract_state, *, fsdp: bool = True):
    """Shardings for the {params, opt{m, v, step}} train state."""
    return {
        "params": param_shardings(mesh, abstract_state["params"], fsdp=fsdp),
        "opt": {
            "m": param_shardings(mesh, abstract_state["opt"]["m"], fsdp=fsdp),
            "v": param_shardings(mesh, abstract_state["opt"]["v"], fsdp=fsdp),
            "step": to_placements(mesh, ()),
        },
    }


def batch_logical(mesh, x) -> tuple:
    dp = dp_axes(mesh)
    if isinstance(x, int):
        return (dp,) + (None,) * (x - 1)
    return _guard(mesh, x.shape, (dp,) + (None,) * (x.ndim - 1))


def batch_spec(mesh, x):
    """Batch-leading activation spec: batch -> dp, rest replicated.

    ``x`` may be an int (ndim; unguarded) or a tensor (meta or real), in
    which case the batch axis falls back to replication when not
    divisible."""
    return to_placements(mesh, batch_logical(mesh, x))


def cache_logical(mesh, name: str, shape) -> tuple:
    dp = dp_axes(mesh)
    leaf, _ = _leaf_name(name)
    nd = len(shape)
    if leaf in ("k", "v", "xk", "xv"):  # (L, b, S, KV*hd)
        s = (None, dp, None, "model")
    elif leaf == "h" and nd == 4:  # mamba state (L, b, di, N)
        s = (None, dp, "model", None)
    elif leaf == "conv":  # (L, b, K-1, di)
        s = (None, dp, None, "model")
    elif leaf == "C":  # mlstm (L, b, H, hd, hd)
        s = (None, dp, None, "model", None)
    elif leaf == "n" and nd == 4:  # mlstm (L, b, H, hd)
        s = (None, dp, None, "model")
    else:  # slstm (L, b, d) / mlstm m (L, b, H)
        s = (None, dp, "model") if nd == 3 else (None, dp) + (None,) * (nd - 2)
    return _guard(mesh, shape, s[:nd])


def cache_shardings(mesh, abstract_cache):
    """KV/SSM/xLSTM cache specs (leaves carry a leading period axis), the
    cache's nesting ``{"b{i}": {name: spec}}``."""
    return {key: {name: to_placements(mesh, cache_logical(mesh, name, t.shape))
                  for name, t in c.items()}
            for key, c in abstract_cache.items()}


# ---------------------------------------------------------------- placement


def place(x, mesh, placements):
    """``x`` as a DTensor of ``placements``.  A plain ``x`` must be the same
    full tensor on every rank (drawn from one seed): each rank keeps its own
    shard, with no communication.  A DTensor is redistributed."""
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements)
    return distribute_tensor(x, mesh, placements, src_data_rank=None)


def place_tree(tree, mesh, shardings):
    """``place`` over a nested dict of tensors and its shardings."""
    if isinstance(tree, dict):
        return {k: place_tree(v, mesh, shardings[k]) for k, v in tree.items()}
    return place(tree, mesh, shardings)


def place_module(module, mesh, shardings):
    """Turn every parameter of ``module`` into a DTensor parameter of its
    placements (``param_shardings``), in place.  Returns the module."""
    for name, p in list(module.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        mod._parameters[leaf] = nn.Parameter(place(p.detach(), mesh, shardings[name]),
                                             requires_grad=p.requires_grad)
    return module
