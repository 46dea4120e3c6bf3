"""Carry weights, states and results between numpy and the port.

``from_numpy`` turns a nested dict, list or tuple of numpy arrays into
tensors on a device, so one numpy seed can feed both the JAX package and the
port; ``to_numpy`` brings a ``Solution`` back to the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.utils._pytree as pytree

from .core.solution import Solution


def from_numpy(tree, device, dtype=None):
    """Every numpy array (or numpy scalar) leaf of ``tree`` as a tensor on
    ``device``.  With ``dtype``, floating-point leaves are cast to it; integer
    and bool leaves keep their type.  Other leaves pass through unchanged."""
    def conv(x):
        if not isinstance(x, (np.ndarray, np.generic)):
            return x
        t = torch.as_tensor(np.asarray(x), device=device)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t

    return pytree.tree_map(conv, tree)


def to_numpy(solution: Solution) -> Solution:
    """The same ``Solution`` with every tensor (ts, ys and its structure,
    status, stats, and any event fields) as a host numpy array."""
    def conv(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x

    return dataclasses.replace(
        solution,
        **{f.name: pytree.tree_map(conv, getattr(solution, f.name))
           for f in dataclasses.fields(solution)},
    )
