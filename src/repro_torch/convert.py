"""Carry weights, states and results between numpy and the port.

``from_numpy`` turns a nested dict, list or tuple of numpy arrays into
tensors on a device, so one numpy seed can feed both the JAX package and the
port; ``to_numpy`` brings a ``Solution`` back to the host;
``lm_params_from_numpy`` turns the JAX package's LM parameter pytree into the
state of the port's ``models.LM``, and ``train_state_from_numpy`` its train
state (parameters and AdamW moments) into the port's;
``example_params_from_numpy`` carries the parameters of the reference's
examples (the CNF's MLP, the latent ODE's weights).
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
    and, for an encoder-decoder config, ``{"enc_blocks", "enc_final_norm"}``,
    as numpy arrays, each block leaf stacked on a leading period axis -- on
    ``device``.  Layer ``p * len(pattern) + i`` takes period ``p`` of block
    ``b{i}``; encoder layer ``p`` period ``p`` of ``enc_blocks["b0"]``.
    Floating leaves are cast to ``dtype``, or by default to the dtype of the
    LM's parameter of that name: ``cfg.dtype`` for weights, float32 for
    norms and for the reference's float32 leaves (the MoE router, Mamba's
    ``A_log``, ``D``, ``dt_bias``, mLSTM's ``wi``, ``wf``).  (bfloat16 leaves
    come out of JAX as ``ml_dtypes.bfloat16``, which torch does not take:
    convert them to float32 first; the cast back to bfloat16 is exact.)"""
    from .models import LM

    want = {name: t.dtype for name, t in LM(cfg, device="meta").state_dict().items()}
    state = {}

    def put(name, x):
        t = torch.as_tensor(np.array(x), device=device)  # a writable copy
        state[name] = t.to(dtype or want[name])

    put("embed", params_np["embed"])
    for top in ("final_norm", "enc_final_norm"):
        for name, x in params_np.get(top, {}).items():
            put(f"{top}.{name}", x)
    for top, pattern in (("blocks", cfg.pattern), ("enc_blocks", ("attn_bidir_mlp",))):
        if top not in params_np:
            continue
        n = len(pattern)
        for i in range(n):
            for sub, leaves in params_np[top][f"b{i}"].items():
                for name, x in leaves.items():
                    x = np.asarray(x)
                    for period in range(cfg.n_periods):
                        put(f"{top}.{period * n + i}.{sub}.{name}", x[period])
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


def example_params_from_numpy(example, params_np, device, dtype=None):
    """The parameter dict of an example from the reference's numpy tree of
    the same keys: ``"cnf"`` (``benchmarks/cnf_bench.init_mlp``'s, for
    ``tools.cnf`` and ``examples.cnf_density``) or ``"latent_ode"``
    (``examples/latent_ode.init_params``'s), each leaf a tensor on
    ``device`` (cast to ``dtype`` if given)."""
    from .examples import latent_ode
    from .tools import cnf

    keys = {"cnf": cnf.KEYS, "latent_ode": latent_ode.KEYS}[example]
    if set(params_np) != set(keys):
        raise ValueError(f"{example}: keys {sorted(params_np)} are not {sorted(keys)}")
    return {k: from_numpy(np.asarray(params_np[k]), device, dtype) for k in keys}
