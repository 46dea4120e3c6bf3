"""Per-device cost of a step, counted over the torch ops it runs (the port's
counterpart of the JAX package's ``launch/hlocost.py``, which parses
compiled HLO; eager PyTorch has no HLO, so this counts the ops as they are
dispatched).

``analyze(fn, *args)`` runs ``fn`` once -- on fake tensors
(``FakeTensorMode``, nothing allocated, nothing computed) or on real ones --
under a dispatch mode that sees every aten op, and returns, per device:

  - ``flops``:       ``torch.utils.flop_counter``'s formulas (2 M N K per
                     matmul; ``bmm``, ``addmm``, ``baddbmm``, convolutions,
                     SDPA); the port's attention kernels by formula, never by
                     their plain versions (below).
  - ``bytes``:       each op's input plus output bytes.  In eager PyTorch
                     every op is a kernel boundary, so this is the
                     counterpart of the reference's "operand + result bytes
                     of top-level (fusion-boundary) ops".  Views move nothing
                     and count nothing.
  - ``collectives``: bytes by kind (``all-gather``, ``all-reduce``,
                     ``reduce-scatter``, ``all-to-all``) and ``total``, in the
                     reference's convention: the largest array of each op.
                     They are the ``_c10d_functional`` ops that DTensor
                     runs.  (On a CPU mesh DTensor turns a shard-to-shard
                     redistribution into an all-gather and a chunk, so it
                     counts as an all-gather there.)
  - ``argument``:    the bytes of the arguments' tensors (a DTensor: its
                     local shard; a module: its parameters and buffers).
  - ``peak``:        ``argument`` plus the high-water mark of the storages the
                     step's ops created that were still referenced.

A DTensor op is let through to DTensor (the mode returns ``NotImplemented``,
as ``CommDebugMode`` does), which runs it as ops on the local shards and
collectives, and those are counted: the counts are one rank's.

The attention: ``flash_attention_fwd`` counts 4 b H hd flops a visible
(query, key) pair and its backward 10 b H hd (PERF.md's conventions for
the CUDA kernels), their inputs and outputs once as bytes.  Their plain
versions, which the CPU runs, compute every block of the scores; they run
uncounted on real tensors and not at all on fake ones (the outputs are
empty tensors of the right shapes).  The kernels' wrappers are patched
only while ``analyze`` runs.
"""

from __future__ import annotations

import contextlib
import weakref
from unittest import mock

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch import nn
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")
_COLLECTIVE = {"all_gather": "all-gather", "all_reduce": "all-reduce",
               "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all"}
# Ops that write nothing a later op reads: the allocation of an output.
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
               "wait_tensor", "lift_fresh", "_local_scalar_dense"}


def _local_tensors(tree):
    """The plain tensors of ``tree`` (a module's parameters and buffers, a
    DTensor's local shard)."""
    out = []
    for x in pytree.tree_leaves(tree):
        if isinstance(x, nn.Module):
            out += _local_tensors([*x.parameters(), *x.buffers()])
        elif isinstance(x, DTensor):
            out.append(x.to_local())
        elif isinstance(x, torch.Tensor):
            out.append(x)
    return out


def _nbytes(t):
    return t.numel() * t.element_size()


def _storage(t):
    s = t.untyped_storage()
    return s._cdata, s.nbytes()


def _collective_kind(func):
    if func.namespace not in ("_c10d_functional", "_c10d_functional_autograd", "c10d"):
        return None
    name = func._opname
    return next((kind for key, kind in _COLLECTIVE.items() if name.startswith(key)), None)


def visible_pairs(sq, sk, causal, q_offset=0):
    """The (query, key) pairs attention reads for one head of one row: all
    sq sk, or with ``causal`` key j <= q_offset + i for query i."""
    if not causal:
        return sq * sk
    return int(np.clip(np.arange(sq) + q_offset + 1, 0, sk).sum())


class CostCounter(TorchDispatchMode):
    """The dispatch mode of ``analyze``: flops, bytes and collective bytes
    of the ops it sees, and the live storages' high-water mark."""

    def __init__(self, arguments=()):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives = dict.fromkeys(KINDS, 0.0)
        self.suspended = 0
        # The arguments' storages are not the step's to allocate; their bytes
        # are those of the tensors (a shard may view a larger storage).
        self._args = {_storage(t)[0] for t in arguments}
        self.argument = float(sum(_nbytes(t) for t in {
            (_storage(t)[0], t.storage_offset(), tuple(t.shape)): t for t in arguments}.values()))
        self._live = {}  # storage key -> [bytes, tensors referencing it]
        self.live = 0
        self.peak_live = 0

    def add(self, flops=0.0, nbytes=0.0):
        if not self.suspended:
            self.flops += flops
            self.bytes += nbytes

    @contextlib.contextmanager
    def uncounted(self):
        """Neither count nor track the ops run inside."""
        self.suspended += 1
        try:
            yield
        finally:
            self.suspended -= 1

    def _release(self, key):
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._live[key]

    def _track(self, t):
        key, n = _storage(t)
        if key in self._args:
            return
        entry = self._live.get(key)
        if entry is None:
            entry = self._live[key] = [n, 0]
            self.live += n
            self.peak_live = max(self.peak_live, self.live)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def tracked(self, out):
        """``out``, its tensors made live (outputs of uncounted work)."""
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it as local ops and collectives
        out = func(*args, **kwargs)
        if self.suspended:
            return out
        outs = [x for x in pytree.tree_leaves(out) if isinstance(x, torch.Tensor)]
        for t in outs:
            self._track(t)
        ins = [x for x in pytree.tree_leaves((args, kwargs)) if isinstance(x, torch.Tensor)]
        kind = _collective_kind(func)
        if kind is not None:
            self.collectives[kind] += max(map(_nbytes, ins + outs), default=0)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if not func.is_view and func._opname not in _NO_TRAFFIC:
            self.bytes += sum(map(_nbytes, ins + outs))
        return out


def _flash_patches(counter):
    """The attention kernels and their plain versions, counted by formula."""
    from ..kernels import cuda_impl, ref

    def fwd_cost(q, k, v, causal, q_offset, lse):
        b, sq, H, hd = q.shape
        pairs = visible_pairs(sq, k.shape[1], causal, q_offset)
        nbytes = sum(map(_nbytes, (q, k, v))) + _nbytes(q) + (4 * b * H * sq if lse else 0)
        counter.add(4.0 * b * H * hd * pairs, nbytes)

    def forward(orig):
        def run(q, k, v, *, causal=True, q_offset=0, lse=False, **kw):
            fwd_cost(q, k, v, causal, q_offset, lse)
            if isinstance(q, FakeTensor):
                b, sq, H, _ = q.shape
                o = torch.empty_like(q)
                return (o, q.new_empty((b, H, sq), dtype=torch.float32)) if lse else o
            with counter.uncounted():
                out = orig(q, k, v, causal=causal, q_offset=q_offset, lse=lse, **kw)
            return counter.tracked(out)
        return run

    def backward(orig):
        def run(q, k, v, o, lse, do, *, causal=True, q_offset=0, **kw):
            b, sq, H, hd = q.shape
            pairs = visible_pairs(sq, k.shape[1], causal, q_offset)
            counter.add(10.0 * b * H * hd * pairs,
                        2 * sum(map(_nbytes, (q, k, v))) + sum(map(_nbytes, (o, lse, do))))
            if isinstance(q, FakeTensor):
                return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
            with counter.uncounted():
                out = orig(q, k, v, o, lse, do, causal=causal, q_offset=q_offset, **kw)
            return counter.tracked(out)
        return run

    return [mock.patch.object(mod, name, wrap(getattr(mod, name)))
            for mod in (ref, cuda_impl)
            for name, wrap in (("flash_attention_fwd", forward), ("flash_attention_bwd", backward))]


def _dtensor_patches(counter):
    """DTensor's own bookkeeping, uncounted.  It infers an op's output shapes
    by running the op on fake tensors of the global shapes, under the
    ambient fake mode; and it sizes a strided shard's local rows by indexing
    a real ``arange``, which must not be made fake (its ``tolist`` would be
    data-dependent).  Neither is the step's work.  These are private names
    of torch's: where a torch has none of them, this raises rather than
    count the propagation as the step's work or fail on a strided shard."""
    import inspect

    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    def quiet(cls, name, real=False):
        orig = getattr(cls, name)

        def run(*a, **k):
            with counter.uncounted(), (unset_fake_temporarily() if real
                                       else contextlib.nullcontext()):
                return orig(*a, **k)

        static = isinstance(inspect.getattr_static(cls, name), staticmethod)
        return mock.patch.object(cls, name, staticmethod(run) if static else run)

    patches = [quiet(ShardingPropagator, name)
               for name in ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")
               if hasattr(ShardingPropagator, name)]
    if not patches:
        raise RuntimeError("this torch's ShardingPropagator has neither "
                           "_propagate_tensor_meta_non_cached nor _propagate_tensor_meta: "
                           "DTensor's shape propagation would be counted as the step's work")
    strided = getattr(placement_types, "_StridedShard", None)
    if strided is not None:
        if not hasattr(strided, "local_shard_size_and_offset"):
            raise RuntimeError("this torch's _StridedShard has no local_shard_size_and_offset: "
                               "a strided shard's sizing would run on fake tensors")
        patches.append(quiet(strided, "local_shard_size_and_offset", real=True))
    return patches


def analyze(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and count its cost per device (see
    the module docstring).  Returns ``{"flops", "bytes", "collectives":
    {kind: bytes, "total"}, "argument", "peak", "result"}``."""
    counter = CostCounter(_local_tensors((args, kwargs)))
    with contextlib.ExitStack() as stack:
        for patch in _flash_patches(counter) + _dtensor_patches(counter):
            stack.enter_context(patch)
        stack.enter_context(counter)
        result = fn(*args, **kwargs)
    coll = dict(counter.collectives)
    coll["total"] = sum(coll[k] for k in KINDS)
    return {"flops": counter.flops, "bytes": counter.bytes,
            "collectives": coll, "argument": counter.argument,
            "peak": counter.argument + counter.peak_live, "result": result}
