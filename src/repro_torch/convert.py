"""Carry weights, states and results between numpy and the port.

``from_numpy`` turns a nested dict, list or tuple of numpy arrays into
tensors on a device, so one numpy seed can feed both the JAX package and the
port; ``to_numpy`` brings a ``Solution`` back to the host;
``lm_params_from_numpy`` turns the JAX package's LM parameter pytree into the
state of the port's ``models.LM``, and ``train_state_from_numpy`` its train
state (parameters and AdamW moments) into the port's.
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


def lm_params_from_numpy(cfg, params_np, device, dtype=None):
    """The ``models.LM`` state (a ``state_dict``) of the reference's
    parameter pytree ``params_np`` -- ``{"embed", "final_norm", "blocks"}``
    as numpy arrays, each block leaf stacked on a leading period axis -- on
    ``device``.  Layer ``p * len(pattern) + i`` takes period ``p`` of block
    ``b{i}``.  Floating leaves are cast to ``dtype``, or by default to the
    dtype the LM gives them: ``cfg.dtype`` for weights, float32 for norm
    parameters, as ``init_params`` makes them.  (bfloat16 leaves come out of
    JAX as ``ml_dtypes.bfloat16``, which torch does not take: convert them to
    float32 first; the cast back to bfloat16 is exact.)"""
    weights = getattr(torch, cfg.dtype)

    def conv(x, norm):
        t = torch.as_tensor(np.array(x), device=device)  # a writable copy
        return t.to(dtype or (torch.float32 if norm else weights))

    state = {"embed": conv(params_np["embed"], False)}
    for name, x in params_np["final_norm"].items():
        state[f"final_norm.{name}"] = conv(x, True)
    n = len(cfg.pattern)
    for i in range(n):
        block = params_np["blocks"][f"b{i}"]
        for sub, leaves in block.items():
            for name, x in leaves.items():
                x = np.asarray(x)
                for period in range(cfg.n_periods):
                    state[f"blocks.{period * n + i}.{sub}.{name}"] = conv(
                        x[period], sub.startswith("ln"))
    return state


def _is_quantized(x):
    return isinstance(x, dict) and set(x) == {"q", "s"}


def _pick(tree, part):
    """``tree`` with every 8-bit moment ``{"q", "s"}`` replaced by its
    ``part``."""
    if _is_quantized(tree):
        return tree[part]
    if isinstance(tree, dict):
        return {k: _pick(v, part) for k, v in tree.items()}
    return tree


def train_state_from_numpy(cfg, state_np, device, dtype=None):
    """The port's train state ``{"params": LM, "opt": {"m", "v", "step"}}``
    of the reference's numpy tree ``{"params", "opt": {"m", "v", "step"}}``
    (``train.steps.init_train_state``'s, e.g. as saved by its
    ``checkpoint.save``), on ``device``.  The parameters go through
    ``lm_params_from_numpy`` (``dtype`` as there); the moments take the same
    mapping, float32, or for 8-bit moments (``{"q", "s"}`` per parameter)
    int8 blocks and float32 scales."""
    from .models import LM

    model = LM(cfg, device=device)
    model.load_state_dict(lm_params_from_numpy(cfg, state_np["params"], device, dtype))
    opt = state_np["opt"]

    def moments(tree):
        if not _is_quantized(tree["embed"]):
            return lm_params_from_numpy(cfg, tree, device, torch.float32)
        q = lm_params_from_numpy(cfg, _pick(tree, "q"), device, torch.int8)
        s = lm_params_from_numpy(cfg, _pick(tree, "s"), device, torch.float32)
        return {name: {"q": q[name], "s": s[name]} for name in q}

    step = torch.as_tensor(np.array(opt["step"]), device=device).to(torch.int32)
    return {"params": model,
            "opt": {"m": moments(opt["m"]), "v": moments(opt["v"]), "step": step}}
