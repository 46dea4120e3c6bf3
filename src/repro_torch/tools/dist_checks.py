"""Multi-rank checks of the port's mesh path, run in spawned gloo processes
on the CPU (``tests/test_torch_distributed_ranks.py``) or in one process on
the card (``chip_smoke.py``'s phase ``distributed``).  The workers live here,
not in a test file, because ``torch.multiprocessing`` pickles its target by
reference.

``start(fn, world, workdir, *args)`` runs ``fn(rank, world, workdir, *args)``
in ``world`` processes of one gloo group (a ``file://`` rendezvous under
``workdir``, a 60 s collective timeout); ``wait`` on its handle waits at
most ``timeout`` seconds, kills the children past it, and returns each
rank's result.  Two groups can run at once.

``train_case`` trains a reduced config three steps on a mesh and the same
steps without one, from the same seed and the same global batches, and
returns both runs' metrics and parameters.  Without a mesh the step is
``make_train_step``'s, except for a MoE config on more than one data rank:
there the mesh's semantics are the reference's expert-parallel path's --
capacity and balance loss per data shard -- so the step without a mesh
takes the mean of each shard's loss (``shard_mean_step``), which is the
same function of the global batch.
"""

from __future__ import annotations

import datetime
import logging
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor

from ..configs import get_config
from ..data import SyntheticTokens
from ..distributed.constraints import activation_sharding
from ..distributed.sharding import cache_shardings, place_module, state_shardings
from ..launch.train import load_state, local_batch, place_state, state_tree
from ..models import forward
from ..optim import adamw_update, clip_by_global_norm
from ..optim.adamw import AdamWConfig
from ..optim.quantized import qadamw_update
from ..train.steps import cross_entropy_loss, init_train_state, make_train_step

GROUP_TIMEOUT_S = 60
B, S, STEPS = 4, 16, 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
MOE_AUX = 0.01


# ------------------------------------------------------------------- spawn


def _entry(rank, fn, world, workdir, rendezvous, args):
    torch.set_num_threads(1)
    # gloo has no all-to-all (DTensor falls back to all-gather + chunk) and
    # reduces a 2-D partial in two all-reduces: both warn on every rank
    logging.getLogger("torch").setLevel(logging.ERROR)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        out = fn(rank, world, workdir, *args)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(workdir, f"result_{rank}.pt"))


def start(fn, world, workdir, *args, timeout=240.0):
    """Start ``fn(rank, world, workdir, *args)`` in ``world`` processes of
    one gloo group; ``wait`` on the returned handle for the results."""
    os.makedirs(workdir, exist_ok=True)
    rendezvous = tempfile.mktemp(prefix="rendezvous_", dir=workdir)  # a new file each call
    ctx = mp.start_processes(_entry, args=(fn, world, workdir, rendezvous, args), nprocs=world,
                             join=False, start_method="spawn")
    return ctx, fn.__name__, world, workdir, time.monotonic() + timeout


def wait(handle):
    """Each rank's result of a ``start``ed group.  A rank that raises fails
    the call; past the group's time limit every child is killed and it
    raises ``TimeoutError``."""
    ctx, name, world, workdir, deadline = handle
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{name}: {world} ranks still running past their limit")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    return [torch.load(os.path.join(workdir, f"result_{r}.pt"), weights_only=False)
            for r in range(world)]


# ------------------------------------------------------------------- helpers


def full(t):
    """A plain tensor of a DTensor (gathered), or the tensor itself."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def gathered(tree):
    """Every leaf of a nested dict as a host numpy array, DTensors gathered
    (a collective: every rank calls it)."""
    if isinstance(tree, dict):
        return {k: gathered(v) for k, v in tree.items()}
    return full(tree.detach()).cpu().numpy().copy()  # not a view of a parameter updated later


def mesh_of(shape, device="cpu"):
    return init_device_mesh(torch.device(device).type, shape, mesh_dim_names=("data", "model"))


def sharding(mesh):
    return activation_sharding(dp=("data",), tp="model", tp_size=mesh.size(1), mesh=mesh)


def shard_mean_step(cfg, opt_cfg, *, n_shards, remat=False, optimizer="adamw"):
    """A train step without a mesh whose loss is the mean over ``n_shards``
    equal row blocks of the batch of each block's loss (cross entropy +
    MOE_AUX x balance): the expert-parallel path's semantics on
    ``n_shards`` data ranks."""
    opt_update = qadamw_update if optimizer == "adamw8bit" else adamw_update

    def step(state, batch):
        model = state["params"]
        params = dict(model.named_parameters())
        n = batch["tokens"].shape[0] // n_shards
        with torch.enable_grad():
            ce = bal = 0.0
            for r in range(n_shards):
                rows = {k: v[r * n:(r + 1) * n] for k, v in batch.items()}
                logits, aux = forward(cfg, model, rows, remat=remat)
                ce = ce + cross_entropy_loss(logits, rows["labels"]) / n_shards
                bal = bal + aux["moe_balance"] / n_shards
            loss = ce + MOE_AUX * bal
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        grads, gn = clip_by_global_norm(grads, opt_cfg.clip_norm)
        _, opt, extra = opt_update(opt_cfg, params, grads, state["opt"])
        return {"params": model, "opt": opt}, {
            "loss": loss.detach(), "ce_loss": ce.detach(), "moe_balance": bal.detach(),
            "grad_norm": gn, **extra}

    return step


def _metrics(m):
    return {k: float(full(v)) for k, v in m.items()}


# ------------------------------------------------------------------- cases


def train_case(rank, world, workdir, case, device="cpu", on_mesh_start=None):
    """Train ``case`` = (arch, mesh shape, fsdp, remat, optimizer) STEPS
    steps without a mesh, then (after ``on_mesh_start()``, if given) on the
    mesh.  Returns ({"ref", "got"}: each step's metrics, and on rank 0
    {"params_ref", "params_got"}: the parameters after each step as numpy,
    the mesh's gathered; the mesh's final state)."""
    arch, shape, fsdp, remat, optimizer = case
    cfg = get_config(arch, reduced=True)
    opt_cfg = AdamWConfig(**OPT)
    ds = SyntheticTokens(vocab=cfg.vocab, seq_len=S, global_batch=B)
    if cfg.moe is not None and shape[0] > 1:
        ref_step = shard_mean_step(cfg, opt_cfg, n_shards=shape[0], remat=remat,
                                   optimizer=optimizer)
    else:
        ref_step = make_train_step(cfg, opt_cfg, moe_aux_weight=MOE_AUX, remat=remat,
                                   optimizer=optimizer)
    ref = init_train_state(cfg, 0, optimizer=optimizer, device=device)
    ref_m, ref_p = [], []
    for i in range(STEPS):
        batch = {k: torch.as_tensor(v, device=device) for k, v in ds.batch(i).items()}
        ref, m = ref_step(ref, batch)
        ref_m.append(_metrics(m))
        ref_p.append(gathered(dict(ref["params"].named_parameters())))

    mesh = mesh_of(shape, device)
    state = place_state(init_train_state(cfg, 0, optimizer=optimizer, device=device), mesh,
                        fsdp=fsdp)
    if on_mesh_start is not None:
        on_mesh_start()
    step = make_train_step(cfg, opt_cfg, moe_aux_weight=MOE_AUX, remat=remat,
                           optimizer=optimizer)
    got_m, got_p = [], []
    for i in range(STEPS):
        batch = local_batch(ds, i, mesh, device)
        with sharding(mesh):
            state, m = step(state, batch)
        got_m.append(_metrics(m))
        got_p.append(gathered(dict(state["params"].named_parameters())))
    out = {"ref": ref_m, "got": got_m}
    if rank == 0:
        out.update(params_ref=ref_p, params_got=got_p)
    return out, state


def placements_of(tree):
    """The placements of every DTensor leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: placements_of(v) for k, v in tree.items()}
    return tuple(tree.placements) if isinstance(tree, DTensor) else None


def four_ranks(rank, world, workdir, cases, ckpt_case, moe_inputs, moe_cf):
    """The 4-rank checks: the expert-parallel MoE on (2, 2), every training
    case, then the checkpoint of ``ckpt_case``'s final state (saved on its
    mesh under workdir/ckpt), with its gathered state and its placements
    against ``state_shardings``."""
    from ..checkpoint import save

    out = {"moe": moe_expert_parallel(rank, world, workdir, moe_inputs, moe_cf)}
    for case in cases:
        out[case], state = train_case(rank, world, workdir, case)
        if case == ckpt_case:
            mesh = mesh_of(case[1])
            tree = state_tree(state)
            save(os.path.join(workdir, "ckpt"), STEPS - 1, tree)
            out["ckpt_tree"] = gathered(tree)
            out["ckpt_placements"] = placements_of(tree)
            out["ckpt_want"] = state_shardings(mesh, state, fsdp=case[2])
    return out


def restore_on(rank, world, workdir, ckpt_dir, arch, shape, fsdp, optimizer="adamw"):
    """Restore the checkpoint in ``ckpt_dir`` onto a new state on ``shape``:
    (its gathered state tree, its placements, the rules' placements)."""
    from ..checkpoint import latest_step, restore

    deadline = time.monotonic() + 200  # the group that writes it may still be training
    while latest_step(ckpt_dir) is None:
        if time.monotonic() > deadline:
            raise TimeoutError(f"no checkpoint in {ckpt_dir}")
        time.sleep(0.5)
    cfg = get_config(arch, reduced=True)
    mesh = mesh_of(shape)
    state = place_state(init_train_state(cfg, 1, optimizer=optimizer, device="cpu"), mesh,
                        fsdp=fsdp)
    sh = state_shardings(mesh, state, fsdp=fsdp)
    want = {"params": sh["params"], "opt": {"m": sh["opt"]["m"], "v": sh["opt"]["v"]}}
    load_state(state, restore(ckpt_dir, latest_step(ckpt_dir), state_tree(state), shardings=want,
                              mesh=mesh))
    return gathered(state_tree(state)), placements_of(state_tree(state)), want


def serve_tokens(rank, world, workdir, arch, model_parallel, gen=4):
    """``launch.serve.run`` of a reduced config on the group's mesh: (the
    greedy tokens, the cache's placements, ``cache_shardings``)."""
    import argparse

    from ..launch import serve

    args = argparse.Namespace(arch=arch, reduced=True, batch=2, prompt_len=16, gen=gen, seed=0,
                              model_parallel=model_parallel, device="cpu")
    out = serve.run(args)
    cache = out["cache"]
    return out["tokens"], placements_of(cache), cache_shardings(out["mesh"], cache)


def two_ranks(rank, world, workdir, cases, ckpt_dir, ckpt_case, serve_archs, launcher_argv):
    """The 2-rank checks: training cases, serving on (1, 2),
    ``psum_compressed``, the train launcher, and last the checkpoint of
    ``ckpt_dir`` (written by a concurrent 4-rank group) restored on (1, 2)."""
    from ..distributed.compression import compress_roundtrip, psum_compressed
    from ..launch import train

    out = {}
    for case in cases:
        out[case], _ = train_case(rank, world, workdir, case)
    for arch in serve_archs:
        out[("serve", arch)] = serve_tokens(rank, world, workdir, arch, 2)
    x = torch.as_tensor(np.random.default_rng(rank).standard_normal((3, 300)), dtype=torch.float32)
    out["psum"] = (x.numpy(), compress_roundtrip(x).numpy(), psum_compressed(x).numpy())
    res = train.run(train.parser().parse_args(launcher_argv))
    out["launcher"] = {"losses": res["losses"], "mesh": tuple(res["mesh"].mesh.shape),
                       "placements": placements_of(dict(res["state"]["params"].named_parameters())),
                       "want": state_shardings(res["mesh"], res["state"], fsdp=True)["params"]}
    arch, _, fsdp, _, optimizer = ckpt_case
    out["restored"] = restore_on(rank, world, workdir, ckpt_dir, arch, (1, 2), fsdp, optimizer)
    return out


def moe_expert_parallel(rank, world, workdir, inputs, capacity_factor, shape=(2, 2)):
    """The reduced deepseek-moe-16b MoE layer of ``inputs`` (numpy weights
    by name and tokens ``x``) through the expert-parallel path on
    ``shape``: (the gathered output, the balance loss, the dropped
    assignments: over each data shard, the assignments past an expert's
    capacity)."""
    import dataclasses

    from ..distributed.sharding import batch_spec, param_logical, place, to_placements
    from ..models.moe import MoE, route

    cfg = get_config("deepseek-moe-16b", reduced=True)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           capacity_factor=capacity_factor))
    moe = MoE(cfg, device="cpu")
    with torch.no_grad():
        for name, p in moe.named_parameters():
            p.copy_(torch.as_tensor(inputs[name]))
    x = torch.as_tensor(inputs["x"])
    T, E, k = x.shape[0], cfg.moe.n_experts, cfg.moe.top_k
    T_loc = T // shape[0]
    C = max(1, int(capacity_factor * k * T_loc / E))
    drops = 0
    for r in range(shape[0]):
        _, _, topi = route(cfg, moe, x[r * T_loc:(r + 1) * T_loc])
        counts = torch.bincount(topi.reshape(-1), minlength=E)
        drops += int(torch.clamp(counts - C, min=0).sum())

    mesh = mesh_of(shape)
    place_module(moe, mesh, {n: to_placements(mesh, param_logical(mesh, f"moe.{n}", p.shape))
                             for n, p in moe.named_parameters()})
    with sharding(mesh):
        out, aux = moe(place(x, mesh, batch_spec(mesh, x)))
    return full(out).detach().numpy(), float(full(aux["moe_balance"])), drops
