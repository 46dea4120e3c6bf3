"""Dry run of every (arch x input shape x mesh) cell on fake tensors (the JAX
package's ``launch/dryrun.py``): does the cell fit, and what bounds it.

Each cell builds the port's train, prefill or decode step on fake tensors
(``FakeTensorMode``: shapes and dtypes, no memory, no arithmetic), places
the state by ``distributed/sharding.py`` on ``launch.mesh.
make_production_mesh`` (16 x 16, or 2 x 16 x 16) over a fake process group
of that many ranks in this one process, runs the step once under
``launch.cost.analyze`` and records, per device:

  - the counted GFLOPs, HBM GB and collective GB by kind (``cost.py``);
  - ``argument`` bytes (the state, or the params and caches, as placed) and
    ``peak``, the high-water mark of the live fake tensors a rank holds;
  - the model FLOPs (``model_flops``) and their share of the counted ones;
  - the three roofline terms on one H100 SXM.

No card is needed: the reference compiled for 512 forced CPU devices, this
runs the ops on fake tensors on the CPU.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch starcoder2-15b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun_results.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor

from ..configs import all_archs, get_config
from ..distributed.constraints import activation_sharding
from ..distributed.sharding import (
    batch_spec,
    cache_shardings,
    dp_axes,
    param_shardings,
    place_module,
    place_tree,
)
from ..models import init_params
from ..models.config import SHAPES
from ..train.steps import init_train_state, make_decode_step, make_prefill_step, make_train_step
from . import cost
from . import specs as S
from .mesh import make_production_mesh
from .train import place_state

# --- H100 SXM 80GB (NVIDIA data sheet), per card.  chip_smoke.py prints the
# card's name and power limit beside every time these are set against.
PEAK_FLOPS = 989e12  # bfloat16 dense, tensor cores
HBM_BW = 3.35e12  # bytes/s, HBM3
NVLINK_BW = 450e9  # bytes/s a direction (NVLink 4, 18 links)


def roofline(per_dev_flops, per_dev_bytes, per_dev_coll_bytes):
    """Three roofline terms in seconds, from per-device counts, each over one
    card's peak; for an even sharding this equals global / (cards x peak)."""
    terms = {
        "compute_s": per_dev_flops / PEAK_FLOPS,
        "memory_s": per_dev_bytes / HBM_BW,
        "collective_s": per_dev_coll_bytes / NVLINK_BW,
    }
    terms["bottleneck"] = max(("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k])
    return terms


def model_flops(cfg, params, shape) -> float:
    """6 N D (train) / 2 N D (inference), the 'useful compute' yardstick
    against which the counted FLOPs are compared.  N counts every parameter,
    a routed expert's weights (``moe`` in the name, ``w_in`` / ``w_gate`` /
    ``w_out`` in its last part) at the active fraction top_k / n_experts,
    the shared experts whole; D is the tokens of ``shape`` (a ``SHAPES``
    name or dict), one a row for decode.  ``params``: an ``LM`` (meta, fake
    or live), a train state with ``"params"``, or a dict by name."""
    sh = S.shape_of(shape)
    d_tokens = sh["global_batch"] * (sh["seq_len"] if sh["kind"] != "decode" else 1)
    if isinstance(params, dict) and "params" in params:
        params = params["params"]
    named = params.named_parameters() if hasattr(params, "named_parameters") else params.items()

    def count(name, leaf):
        parts = name.split(".")
        n = float(math.prod(leaf.shape))
        if "moe" in parts and any(w in parts[-1] for w in ("w_in", "w_gate", "w_out")) \
                and "shared" not in parts[-1]:
            n *= cfg.moe.top_k / cfg.moe.n_experts  # routed experts: active fraction
        return n

    factor = 6.0 if sh["kind"] == "train" else 2.0
    return factor * sum(count(n, p) for n, p in named) * d_tokens


def _needs_remat(cfg) -> bool:
    # large dense/moe models at 4k x 256 need activation checkpointing to fit;
    # enc-dec runs two stacks (encoder residuals + cross-attention), so always
    return cfg.enc_dec or cfg.d_model * cfg.n_layers >= 2048 * 28


@contextlib.contextmanager
def fake_process_group(world: int):
    """A process group of ``world`` ranks in this process, this one rank 0
    (``torch.testing``'s fake backend: collectives move nothing), ended on
    exit.  Refuses to run beside a group the caller started."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("dryrun: a process group is already initialized; the dry run "
                           "starts a fake one of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_dims(multi_pod: bool, mesh_shape=None):
    """(shape, dim names) of the production mesh, or of ``mesh_shape`` over
    ("data", "model") / ("pod", "data", "model")."""
    shape = tuple(mesh_shape) if mesh_shape else ((2, 16, 16) if multi_pod else (16, 16))
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return shape, names


def _fake(t):
    """A fake zero tensor of a meta spec's shape and dtype."""
    return torch.zeros(t.shape, dtype=t.dtype)


def lower_cell(arch: str, shape, *, multi_pod: bool = False, fsdp: bool = True,
               remat: str = "auto", optimizer: str = "adamw", reduced: bool = False,
               mesh_shape=None):
    """Build one cell's step on fake tensors, placed on a fake mesh, and
    count it.  Returns ``(result, info)``: the step's fake outputs, or None
    for a cell ``specs.cell_runnable`` refuses (``info["skipped"]`` says
    why).  ``shape`` is a ``SHAPES`` name or a dict of its keys;
    ``reduced`` takes the config's reduced twin and ``mesh_shape`` another
    mesh than the production one (for tests and small cells)."""
    cfg = get_config(arch, reduced=reduced)
    shape_name = shape if isinstance(shape, str) else "custom"
    ok, why = S.cell_runnable(cfg, shape_name)
    dims, names = mesh_dims(multi_pod, mesh_shape)
    tag = "x".join(map(str, dims))
    if not ok:
        return None, {"arch": arch, "shape": shape_name, "mesh": tag, "skipped": why}
    sh = S.shape_of(shape)
    n_chips = math.prod(dims)
    t0 = time.perf_counter()
    with fake_process_group(n_chips):
        mesh = (init_device_mesh("cpu", dims, mesh_dim_names=names) if mesh_shape
                else make_production_mesh(multi_pod=multi_pod, device="cpu"))
        counted, mf = _count_cell(cfg, sh, mesh, fsdp=fsdp, remat=remat, optimizer=optimizer)
    seconds = time.perf_counter() - t0
    coll = counted["collectives"]
    info = {
        "arch": arch,
        "shape": shape_name,
        "mesh": tag,
        "kind": sh["kind"],
        "n_chips": n_chips,
        "count_s": round(seconds, 1),
        "per_device": {
            "gflops": counted["flops"] / 1e9,
            "hbm_gbytes": counted["bytes"] / 1e9,
            "collective_gbytes": coll["total"] / 1e9,
            "collectives": {k: v / 1e9 for k, v in coll.items()},
        },
        "model_gflops_global": mf / 1e9,
        "useful_flops_ratio": mf / max(counted["flops"] * n_chips, 1.0),
        "per_device_bytes": {"argument": counted["argument"], "peak": counted["peak"]},
        "roofline": roofline(counted["flops"], counted["bytes"], coll["total"]),
    }
    return counted["result"], info


def _count_cell(cfg, sh, mesh, *, fsdp, remat, optimizer):
    """The step of shape ``sh`` on fake tensors placed on ``mesh``, counted:
    (``cost.analyze``'s result, the model FLOPs)."""
    kind = sh["kind"]
    with FakeTensorMode(allow_non_fake_inputs=True):
        if kind == "train":
            use_remat = (remat == "on") or (remat == "auto" and _needs_remat(cfg))
            state = place_state(init_train_state(cfg, 0, optimizer=optimizer, device="cpu"),
                                mesh, fsdp=fsdp)
            step = make_train_step(cfg, remat=use_remat, optimizer=optimizer)
            inputs = (state, _batch(cfg, sh, mesh, with_labels=True))
            params = state["params"]
        else:
            params = init_params(cfg, 0, "cpu")
            place_module(params, mesh, param_shardings(mesh, params, fsdp=fsdp))
            if kind == "prefill":
                step = make_prefill_step(cfg)
                inputs = (params, _batch(cfg, sh, mesh, with_labels=False))
            elif kind == "decode":
                step = make_decode_step(cfg)
                token, pos, cache = S.decode_specs(cfg, sh)
                cache = place_tree({k: {n: _fake(t) for n, t in c.items()}
                                    for k, c in cache.items()},
                                   mesh, cache_shardings(mesh, cache))
                token, pos = (distribute_tensor(_fake(t), mesh, batch_spec(mesh, t),
                                                src_data_rank=None) for t in (token, pos))
                inputs = (params, token, pos, cache)
            else:
                raise ValueError(kind)
        with activation_sharding(dp=dp_axes(mesh), tp="model", tp_size=mesh.size(-1),
                                 mesh=mesh):
            counted = cost.analyze(step, *inputs)
    return counted, model_flops(cfg, params, sh)


def _batch(cfg, sh, mesh, *, with_labels):
    """The step's batch as fake DTensors of ``batch_spec``."""
    specs = S.batch_specs(cfg, sh, with_labels=with_labels)
    return {k: distribute_tensor(_fake(t), mesh, batch_spec(mesh, t), src_data_rank=None)
            for k, t in specs.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--remat", default="auto", choices=["auto", "on", "off"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = all_archs() if args.all or args.arch is None else [args.arch]
    shapes = list(SHAPES) if args.all or args.shape is None else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
                try:
                    out, info = lower_cell(arch, shape, multi_pod=mp, fsdp=not args.no_fsdp,
                                           remat=args.remat)
                except Exception as e:  # noqa: BLE001 -- report, don't abort the sweep
                    info = {"arch": arch, "shape": shape,
                            "mesh": "2x16x16" if mp else "16x16", "error": repr(e)[:500]}
                    print(f"[FAIL] {tag}: {info['error']}", flush=True)
                    results.append(info)
                    continue
                if out is None:
                    print(f"[SKIP] {tag}: {info['skipped']}", flush=True)
                else:
                    r = info["roofline"]
                    print(
                        f"[OK]   {tag}: count={info['count_s']}s "
                        f"compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
                        f"collective={r['collective_s']:.4f}s -> {r['bottleneck']} "
                        f"peak/device={info['per_device_bytes']['peak']/2**30:.2f}GiB",
                        flush=True,
                    )
                results.append(info)
                del out

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
        print(f"wrote {args.out}")
    failed = [r for r in results if "error" in r]
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
