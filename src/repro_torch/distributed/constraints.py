"""Activation sharding constraints (the JAX package's
``distributed/constraints.py``).

FSDP shards weights over the data dims; without anchors, DTensor's sharding
propagation carries those weight placements INTO the activations (the batch
replicated, d_model sharded on data).  Anchoring the residual stream at
period boundaries puts the all-gathers on the (small) weights instead,
which is the whole point of ZeRO-3.

The model code calls ``constrain(x, *spec)`` with LOGICAL axis names
("dp", "tp", None); launchers activate a mapping to mesh dims for the
duration of a step.  When inactive, or for a tensor that is not a DTensor,
``constrain`` returns its input itself.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.utils._pytree as pytree
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate

from .sharding import mesh_axes, to_placements

_state = threading.local()


def _mapping():
    return getattr(_state, "mapping", None)


@contextlib.contextmanager
def activation_sharding(dp=("data",), tp="model", tp_size=None, mesh=None):
    """Enable the logical->mesh mapping for ``constrain()``.

    ``tp_size`` (the model dim's extent) lets layers pick
    divisibility-dependent strategies (head- or row-sharded attention for
    GQA).  ``mesh`` (a ``DeviceMesh``) enables the ``local_map`` layers
    (the expert-parallel MoE, the attention kernel on local heads).  Inside,
    a plain tensor met by a DTensor op counts as replicated
    (``implicit_replication``): positions, masks and RoPE frequencies are
    the same on every rank."""
    prev = _mapping()
    prev_implicit = torch._C._get_dtensor_allow_implicit_replication()
    _state.mapping = {
        "dp": tuple(dp), "tp": tp, None: None, "_tp_size": tp_size, "_mesh": mesh,
    }
    try:
        torch._C._set_dtensor_allow_implicit_replication(True)
        yield
    finally:
        torch._C._set_dtensor_allow_implicit_replication(prev_implicit)
        _state.mapping = prev


def tp_size():
    """Model-dim size under the active mapping, or None when inactive."""
    m = _mapping()
    return m.get("_tp_size") if m else None


def current_mesh():
    """Mesh under the active mapping (for the local_map layers), or None."""
    m = _mapping()
    return m.get("_mesh") if m else None


def logical_axes():
    m = _mapping()
    if m is None:
        return None, None
    return m["dp"], m["tp"]


def resolve(mesh, *spec):
    """The placement spec, on ``mesh``, of a logical spec under the active
    mapping (mesh dims the mesh lacks are dropped)."""
    m = _mapping()
    names = mesh_axes(mesh)

    def one(s):
        axis = m.get(s, None)
        if isinstance(axis, tuple):
            axis = tuple(a for a in axis if a in names) or None
        return axis if axis is None or isinstance(axis, tuple) or axis in names else None

    return to_placements(mesh, tuple(one(s) for s in spec))


def constrain(x, *spec):
    """Redistribute a DTensor to the logical ``spec``; the input itself
    outside launchers or for a plain tensor."""
    m = _mapping()
    if m is None or not isinstance(x, DTensor):
        return x
    placements = resolve(x.device_mesh, *spec)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


# ---------------------------------------------------------------- local maps
#
# The layers below run on each rank's local shards (``local_map``): a CUDA
# kernel never sees a DTensor.


def rows(mesh, ndim: int) -> tuple:
    """Placements of a batch-leading activation: batch on dp, the rest
    replicated (the residual stream's anchor)."""
    return resolve(mesh, "dp", *([None] * (ndim - 1)))


def replicated(mesh) -> tuple:
    return tuple(Replicate() for _ in mesh_axes(mesh))


def summed_over_dp(mesh) -> tuple:
    """The gradient placements of a weight gathered whole and applied to
    each data rank's own rows: partial sums over dp, equal over the rest."""
    dp = set(logical_axes()[0] or ())
    return tuple(Partial() if name in dp else Replicate() for name in mesh_axes(mesh))


def shard_index(mesh, dims) -> int:
    """This rank's flat index over the mesh dims ``dims`` (in mesh order),
    which shard one tensor dim: the block of it this rank holds."""
    coord, index = mesh.get_coordinate(), 0
    for i in dims:
        index = index * mesh.size(i) + coord[i]
    return index


def as_dtensor(x, mesh):
    """A DTensor of ``x``: itself if it is one, else replicated (a plain
    tensor that is the same on every rank)."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, replicated(mesh), run_check=False)


class _Call(nn.Module):
    def __init__(self, module, fn):
        super().__init__()
        self.m, self.fn = module, fn

    def forward(self, *args):
        return self.fn(*args)


def rows_map(fn, module, *xs):
    """``fn(*xs)`` on each rank's batch rows, with ``module``'s weights
    gathered whole (``torch.func.functional_call``): for layers whose
    instances are independent rows (the recurrent mixers, the
    continuous-depth solve).  The tensors of ``xs`` (nested in dicts or
    not) are DTensors, or plain tensors the same on every rank, with the
    batch leading; every tensor output comes back as a DTensor of
    batch-sharded rows.  A weight's gradient is the sum over the data
    ranks."""
    mesh = current_mesh()
    grad_pl = summed_over_dp(mesh)
    local_w = {f"m.{n}": w.redistribute(mesh, replicated(mesh)).to_local(grad_placements=grad_pl)
               for n, w in module.named_parameters() if isinstance(w, DTensor)}
    local_x = pytree.tree_map(
        lambda x: as_dtensor(x, mesh).redistribute(mesh, rows(mesh, x.ndim)).to_local()
        if isinstance(x, torch.Tensor) else x, xs)
    out = torch.func.functional_call(_Call(module, fn), local_w, tuple(local_x))
    return pytree.tree_map(
        lambda t: DTensor.from_local(t, mesh, rows(mesh, t.ndim), run_check=False)
        if isinstance(t, torch.Tensor) else t, out)


def assign_(dst, src):
    """``dst.copy_(src)``, in ``dst``'s own placements for a DTensor (a
    cache leaf keeps its layout)."""
    if isinstance(dst, DTensor):
        src = as_dtensor(src, dst.device_mesh).redistribute(dst.device_mesh, dst.placements)
        dst.to_local().copy_(src.to_local())
    else:
        dst.copy_(src)
    return dst
