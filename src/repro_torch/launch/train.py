"""Training launcher (the JAX package's ``launch/train.py``): AdamW steps of
an LM on synthetic tokens, with async atomic checkpoints, resume from the
latest one, a step watchdog and restart supervision, optional per-period
remat and continuous depth (``--ode-depth``), on one device or on a mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b --reduced \\
        --steps 30 --batch 8 --seq 64 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b --full \\
        --steps 3 --batch 2 --seq 2048 [--remat] [--optimizer adamw8bit] [--ode-depth]

The weights are drawn on the device from ``--seed``; the batches come from
``data.SyntheticTokens`` (the reference's, bit for bit).  ``--device cuda``
(the default) raises without a card.

The mesh: with ``--model-parallel N``, ``--fsdp`` or a default process
group of more than one rank, the run is sharded over
``launch.mesh.make_local_mesh(model=N)`` ("data" x "model" over the group's
ranks; a group of this process alone is started if there is none, NCCL on
the card, gloo on the CPU).  The state is placed by
``distributed.state_shardings(..., fsdp=--fsdp)`` and the steps run inside
``activation_sharding``; each data rank reads only its rows of the global
batch (``SyntheticTokens.batch(step, lo=, hi=)``), so the global batch is the
same for any mesh.  Each rank of a group runs this launcher:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --model-parallel 2 --fsdp
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import contextlib
import functools
import os

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from ..checkpoint import CheckpointManager, latest_step, restore
from ..configs import get_config
from ..data import SyntheticTokens
from ..distributed.constraints import activation_sharding, assign_
from ..distributed.sharding import batch_spec, place_module, place_tree, state_shardings
from ..launch.fault_tolerance import RestartPolicy, Watchdog
from ..launch.mesh import make_local_mesh
from ..optim.adamw import AdamWConfig
from ..train.steps import init_train_state, make_train_step

PHASES = ("forward", "backward", "optimizer")


def state_tree(state):
    """The checkpointed tree of a train state: the LM's parameters by name
    and the optimizer state."""
    return {"params": dict(state["params"].named_parameters()), "opt": state["opt"]}


def load_state(state, tree):
    """Copy a restored ``state_tree`` into ``state`` in place."""
    def copy(dst, src):
        if isinstance(dst, dict):
            for k in dst:
                copy(dst[k], src[k])
        else:
            assign_(dst, src)

    with torch.no_grad():
        copy(state_tree(state), tree)
    return state


def wants_mesh(args) -> bool:
    """Whether a run shards: ``--model-parallel`` above 1, ``--fsdp``, or a
    process group of more than one rank (started, or set up in the
    environment by a launcher such as ``torchrun``)."""
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", 1)))
    return getattr(args, "model_parallel", 1) > 1 or getattr(args, "fsdp", False) or world > 1


def place_state(state, mesh, *, fsdp):
    """Place a train state (the same full tensors on every rank) on
    ``mesh`` in place: the LM's parameters and the moments in
    ``state_shardings``; the step stays a plain tensor.  Returns it."""
    sh = state_shardings(mesh, state, fsdp=fsdp)
    place_module(state["params"], mesh, sh["params"])
    for k in ("m", "v"):
        state["opt"][k] = place_tree(state["opt"][k], mesh, sh["opt"][k])
    return state


def local_batch(ds, step, mesh, device):
    """This rank's rows of the global batch of ``step`` as DTensors of
    ``batch_spec``: rows [lo, hi) by its flat index over the data dims."""
    shape = (ds.global_batch, ds.seq_len)
    spec = batch_spec(mesh, torch.empty(shape, device="meta"))
    lo, hi, coord = 0, ds.global_batch, mesh.get_coordinate()
    for i, pl in enumerate(spec):
        if isinstance(pl, Shard):
            n = (hi - lo) // mesh.size(i)
            lo, hi = lo + coord[i] * n, lo + (coord[i] + 1) * n
    return {k: DTensor.from_local(torch.as_tensor(v, device=device), mesh, spec, run_check=False,
                                  shape=shape, stride=(ds.seq_len, 1))
            for k, v in ds.batch(step, lo=lo, hi=hi).items()}


class StepTimer:
    """ms of each phase of a train step (``make_train_step``'s ``timer``):
    CUDA events on the card, the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def _now(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def start(self):
        self.marks = [("start", self._now())]

    def __call__(self, phase):
        self.marks.append((phase, self._now()))

    def ms(self):
        """{phase: ms, "step": ms} of the last step (after its work ended)."""
        def between(a, b):
            return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

        out = {name: between(self.marks[i][1], t) for i, (name, t) in enumerate(self.marks[1:])}
        out["step"] = between(self.marks[0][1], self.marks[-1][1])
        return out


def run(args) -> dict:
    """Train ``args.steps`` steps (resuming from the latest checkpoint in
    ``args.ckpt_dir``).  Returns the losses and grad norms of the steps
    taken, each step's phase times (``step_ms``), the other metrics, the
    wall time, the first step and the final ``state``."""
    device = torch.device(getattr(args, "device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device is available; pass --device cpu")
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.ode_depth:
        cfg = dataclasses.replace(cfg, ode_depth=True, n_layers=len(cfg.pattern))
    optimizer = getattr(args, "optimizer", "adamw")

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps)
    step_fn = make_train_step(cfg, opt_cfg, remat=args.remat, optimizer=optimizer)
    ds = SyntheticTokens(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)
    mgr = CheckpointManager(args.ckpt_dir, keep=2) if args.ckpt_dir else None

    mesh, sharding = None, contextlib.nullcontext
    own_group = not dist.is_initialized()
    if wants_mesh(args):
        mesh = make_local_mesh(model=getattr(args, "model_parallel", 1), device=device)
        sharding = functools.partial(activation_sharding, dp=("data",), tp="model",
                                     tp_size=mesh.size(1), mesh=mesh)
    state = init_train_state(cfg, args.seed, optimizer=optimizer, device=device)
    if mesh is not None:
        place_state(state, mesh, fsdp=getattr(args, "fsdp", False))
    start = 0
    if args.ckpt_dir and (ls := latest_step(args.ckpt_dir)) is not None:
        load_state(state, restore(args.ckpt_dir, ls, state_tree(state)))
        start = ls + 1
        print(f"[train] resumed from step {ls}")

    wd = Watchdog(timeout_s=args.step_timeout)
    timer = StepTimer(device)
    losses, grad_norms, step_ms, metrics_log = [], [], [], []
    t0 = time.time()
    for step in range(start, args.steps):
        if mesh is None:
            batch = {k: torch.as_tensor(v, device=device) for k, v in ds.batch(step).items()}
        else:
            batch = local_batch(ds, step, mesh, device)
        timer.start()
        with sharding():
            state, metrics = wd.run(lambda: step_fn(state, batch, timer=timer))
        step_ms.append(timer.ms())
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics_log.append(metrics)
        losses.append(metrics["loss"])
        grad_norms.append(metrics["grad_norm"])
        if step % args.log_every == 0:
            print(f"[train] step={step} loss={losses[-1]:.4f} gn={grad_norms[-1]:.3f} "
                  f"lr={metrics['lr']:.2e} ms={step_ms[-1]['step']:.1f}", flush=True)
        if mgr and step % args.ckpt_every == 0 and step > 0:
            mgr.save_async(step, state_tree(state))
    dt = time.time() - t0
    if mgr:
        mgr.save_async(args.steps - 1, state_tree(state))
        mgr.wait()
        mgr.close()
    if mesh is not None and own_group:
        # the group this run started ends with it (its DTensors stay readable
        # on their own shards, ``to_local()``)
        dist.destroy_process_group()
    return {"losses": losses, "grad_norms": grad_norms, "step_ms": step_ms,
            "metrics": metrics_log, "wall_s": dt, "start": start, "state": state, "mesh": mesh}


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--ode-depth", action="store_true")
    ap.add_argument("--optimizer", default="adamw", choices=("adamw", "adamw8bit"))
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--step-timeout", type=float, default=600.0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    policy = RestartPolicy(max_restarts=args.max_restarts)
    out = policy.supervise(lambda: run(args))
    print(f"[train] done: first loss {out['losses'][:1]} last loss {out['losses'][-1:]} "
          f"wall {out['wall_s']:.1f}s")
    return out


if __name__ == "__main__":
    main()
