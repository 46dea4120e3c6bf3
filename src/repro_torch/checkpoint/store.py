"""Fault-tolerant checkpointing (the JAX package's ``checkpoint/store.py``),
in its format and with its guarantees:

  - atomicity: a checkpoint directory becomes visible only by rename() after
    every file is written and fsynced, so a crash mid-write never leaves an
    unreadable "latest" checkpoint
  - async: ``CheckpointManager.save_async`` copies every tensor to host
    memory before it returns and writes on a background thread (a bounded
    queue of 1: back-pressure instead of growing memory).  The copy comes
    first because the optimizer updates the card's tensors in place: a
    thread reading them later would race the next step
  - self-describing: ``manifest.json`` records the step, each leaf's path,
    shape and dtype

Format: ``<dir>/step_00000123/{arrays.npz, manifest.json}`` (a tmp dir
renamed into place); leaf i is ``leaf_{i}``, leaves in sorted-key order of
the nested dicts (as ``jax.tree_util`` flattens them), bfloat16 stored as
its uint16 bits.  A tree is nested dicts (lists, tuples) of tensors or
numpy arrays.

Under a mesh the leaves may be DTensors: ``save`` writes global arrays (each
gathered with ``full_tensor()``, a collective every rank joins; rank 0
writes), as the reference writes global shapes, and ``restore(...,
shardings=, mesh=)`` places each leaf onto any target mesh, the
reference's elastic re-scale.
"""

from __future__ import annotations

import json
import os
import queue
import re
import shutil
import tempfile
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..distributed.sharding import place


def _items(tree, prefix=()):
    """(path, leaf) in the reference's flatten order: dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _items(x, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _spec_items(tree, prefix=()):
    """(path, placement spec) of a shardings tree (nested dicts whose leaves
    are tuples of placements)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_items(tree[k], prefix + (str(k),))
    else:
        yield "/".join(prefix), tree


def _to_host(x):
    """A host numpy copy of a leaf and its dtype name; bfloat16 as uint16."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if isinstance(t, DTensor):
            t = t.full_tensor()
        dtype = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        a = t.to("cpu", copy=True).numpy()
        return (a.view(np.uint16) if dtype == "bfloat16" else a), dtype
    a = np.array(x)
    if a.dtype.name == "bfloat16":  # an ml_dtypes array
        return a.view(np.uint16), "bfloat16"
    return a, str(a.dtype)


def host_copy(tree):
    """[(path, host array, dtype name)] of every leaf of ``tree``."""
    return [(path, *_to_host(x)) for path, x in _items(tree)]


def _write(directory, step, leaves):
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=directory)
    try:
        with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
            np.savez(f, **{f"leaf_{i}": a for i, (_, a, _) in enumerate(leaves)})
            f.flush()
            os.fsync(f.fileno())
        manifest = {
            "step": step,
            "names": [path for path, _, _ in leaves],
            "shapes": [list(a.shape) for _, a, _ in leaves],
            "dtypes": [dtype for _, _, dtype in leaves],
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        final = os.path.join(directory, f"step_{step:08d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        return final
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _writer():
    """Whether this process writes: rank 0 of a process group, or the only one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def save(directory: str, step: int, tree) -> str:
    """Synchronous atomic save of a tree of tensors (or numpy arrays).  In
    a process group every rank calls it (the DTensors are gathered), rank 0
    writes, and every rank returns once the checkpoint is visible."""
    leaves = host_copy(tree)
    final = os.path.join(directory, f"step_{step:08d}")
    if _writer():
        final = _write(directory, step, leaves)
    if dist.is_initialized():
        dist.barrier()
    return final


def _steps(directory):
    return [int(m.group(1)) for d in os.listdir(directory)
            if (m := re.fullmatch(r"step_(\d+)", d))]


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return max(steps) if steps else None


def _leaf(a, dtype):
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def restore(directory: str, step: int, like_tree=None, shardings=None, mesh=None):
    """The checkpoint of ``step``.  With ``like_tree`` (a tree of the same
    structure), a tree of tensors shaped like it, each on its like leaf's
    device (a DTensor like leaf: in its mesh and placements); without,
    nested dicts of CPU tensors keyed by the manifest's paths (e.g. the
    reference's own checkpoints, for ``convert.train_state_from_numpy``
    after ``.numpy()``).  With ``shardings`` (the like tree's placement
    specs, ``distributed.state_shardings``) and ``mesh``, each leaf is
    placed onto ``mesh`` whatever mesh wrote it."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        leaves = [_leaf(data[f"leaf_{i}"], dt) for i, dt in enumerate(manifest["dtypes"])]
    if like_tree is None:
        out = {}
        for name, x in zip(manifest["names"], leaves):
            *parents, last = name.split("/")
            node = out
            for key in parents:
                node = node.setdefault(key, {})
            node[last] = x
        return out
    like = list(_items(like_tree))
    if [p for p, _ in like] != manifest["names"]:
        raise ValueError(f"checkpoint {path} does not hold the tree's leaves")
    specs = dict(_spec_items(shardings)) if shardings is not None else {}

    def put(p, t, x):
        if not isinstance(t, torch.Tensor):
            return x
        if isinstance(t, DTensor):
            return place(x.to(t.to_local().device), mesh or t.device_mesh,
                         specs.get(p, t.placements))
        x = x.to(t.device)
        return place(x, mesh, specs[p]) if p in specs and mesh is not None else x

    by_path = {p: put(p, t, x) for (p, t), x in zip(like, leaves)}

    def rebuild(tree, prefix=()):
        if isinstance(tree, dict):
            return {k: rebuild(v, prefix + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(x, prefix + (str(i),)) for i, x in enumerate(tree))
        return by_path["/".join(prefix)]

    return rebuild(like_tree)


class CheckpointManager:
    """Async checkpointing with a bounded background queue and retention."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self._errors: list = []

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                step, leaves = item
                try:
                    _write(self.directory, step, leaves)
                    self._gc()
                except Exception as e:  # noqa: BLE001
                    self._errors.append(e)
            finally:
                self._q.task_done()

    def _gc(self):
        for s in sorted(_steps(self.directory))[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

    def save_async(self, step: int, tree):
        # copy every tensor to host memory NOW: the train loop updates the
        # card's tensors in place at its next step (in a process group every
        # rank gathers, rank 0 writes)
        leaves = host_copy(tree)
        if _writer():
            self._q.put((step, leaves))  # blocks while a save is in flight

    def wait(self):
        self._q.join()

    def close(self):
        self._q.put(None)
        self._worker.join(timeout=30)
        if self._errors:
            raise self._errors[0]

