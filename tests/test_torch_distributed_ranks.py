"""The port's mesh path on several ranks: gloo processes on the CPU,
spawned once per group size for the whole module (``tools/dist_checks.py``:
a ``file://`` rendezvous under ``tmp_path``, a 60 s collective timeout, and
a limit on the join past which every child is killed).

Four ranks -- meshes (2, 2) and (1, 4):
- the expert-parallel MoE (reduced deepseek-moe-16b at capacity factor
  0.5, so that assignments drop) against the reference's
  ``_moe_apply_shardmap`` under a (2, 2) ``jax.sharding.Mesh`` in a
  subprocess (``--xla_force_host_platform_device_count=8``): the output
  within 1e-5 of its largest entry (the router is a float32 island, ROADMAP
  C), the balance loss within 1e-6 relative, the dropped assignments equal
  and not zero;
- three training steps of stablelm-3b (MHA: heads sharded), qwen2.5-14b
  (H = 4, KV = 2: heads sharded at tp = 2, query rows at tp = 4),
  deepseek-moe-16b (expert parallel), jamba (Mamba + MoE) and xlstm-350m
  (mLSTM, sLSTM), FSDP on and off, remat on one case, and the 8-bit moments
  with a last-dim shard (stablelm's wq moments on (1, 4));
- a checkpoint of the (2, 2) FSDP state, its placements the rules'.

Two ranks, at the same time -- meshes (2, 1) and (1, 2): more training
cases; that checkpoint restored bitwise on (1, 2) (and, here, in one process);
``launch.serve.run --model-parallel 2`` for qwen2.5-14b, jamba and
xlstm-350m (greedy tokens equal to one process's, the caches in
``cache_shardings``' placements); ``psum_compressed``; and
``launch.train.run --model-parallel 2 --fsdp`` lowering the loss.

Each training case is held to the same steps without a mesh, from the same
seed and the same global batches (``dist_checks.train_case``; the single
process is held to the reference in ``test_torch_train.py``).  Partial sums
reorder float32 additions, so: loss and cross entropy within 1e-5
relative at each step, lr within 1e-7; the gradient norm within 1e-5
relative, 1e-4 for jamba and xlstm, whose float32 islands (the Mamba scan,
the xLSTM cells) amplify a reordered sum step by step (their first step's
within 1e-6); the parameters after the third step, 99.9 % of the entries
within 1e-6 as ``_hold_params`` holds them, and every entry within 5e-4,
half a step of lr 1e-3 (``_hold_params`` takes 1e-4).  AdamW moves an
entry by lr * g / (|g| + eps), so an entry whose gradient is near eps
moves by a share of the step that a reordered float32 sum of g changes:
the entries that part are such, e.g. deepseek's blocks.1.attn.wo[23, 9]
(gradient 6.4e-9 against a median 1.0e-2) parts by 3.6e-4 on (1, 2), and
jamba's blocks.5.mamba.in_proj[20, 215] (1.1e-8 against 2.2e-3) by 1.3e-4,
both at the first step.  The 8-bit moments: the first two steps' metrics
and the parameters after the first, as ``HELD_STEPS`` holds them against
the reference.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.distributed.tensor import Replicate  # noqa: E402

from repro_torch.checkpoint import latest_step, restore  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.moe import MoE  # noqa: E402
from repro_torch.tools import dist_checks as dc  # noqa: E402

CASES4 = [("stablelm-3b", (2, 2), True, False, "adamw"),
          ("stablelm-3b", (1, 4), False, False, "adamw8bit"),
          ("qwen2.5-14b", (1, 4), False, False, "adamw"),
          ("qwen2.5-14b", (2, 2), True, True, "adamw"),
          ("deepseek-moe-16b", (2, 2), True, False, "adamw"),
          ("jamba-v0.1-52b", (2, 2), True, False, "adamw"),
          ("xlstm-350m", (1, 4), False, False, "adamw")]
CASES2 = [("stablelm-3b", (2, 1), True, False, "adamw"),
          ("deepseek-moe-16b", (1, 2), False, False, "adamw"),
          ("jamba-v0.1-52b", (1, 2), True, True, "adamw"),
          ("xlstm-350m", (2, 1), True, False, "adamw")]
CKPT_CASE = CASES4[0]
SERVE_ARCHS = ["qwen2.5-14b", "jamba-v0.1-52b", "xlstm-350m"]
LAUNCHER = ["--arch", "stablelm-3b", "--steps", "8", "--batch", "4", "--seq", "16", "--device",
            "cpu", "--model-parallel", "2", "--fsdp", "--log-every", "100", "--lr", "3e-3"]
ISLANDS = {"jamba-v0.1-52b", "xlstm-350m"}
HELD_STEPS = {"adamw": dc.STEPS, "adamw8bit": 2}
PARAMS_AFTER = {"adamw": dc.STEPS, "adamw8bit": 1}
MOE_CF = 0.5
MOE_T = 32

MOE_REFERENCE = r'''
import os, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.distributed.constraints import activation_sharding
from repro.models import moe

inputs = dict(np.load(sys.argv[1]))
cf = float(sys.argv[3])
cfg = get_config("deepseek_moe_16b", reduced=True)
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
x = jnp.asarray(inputs.pop("x"))
p = {k: jnp.asarray(v) for k, v in inputs.items()}
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
with mesh, activation_sharding(dp=("data",), tp="model", tp_size=2, mesh=mesh):
    out, aux = jax.jit(lambda p, x: moe.moe_apply(cfg, p, x))(p, x)
E, k = cfg.moe.n_experts, cfg.moe.top_k
T_loc = x.shape[0] // 2
C = max(1, int(cf * k * T_loc / E))
drops = 0
for r in range(2):
    xs = x[r * T_loc:(r + 1) * T_loc]
    probs = jax.nn.softmax((xs @ p["router"]).astype(jnp.float32), axis=-1)
    topi = jax.lax.top_k(probs, k)[1]
    counts = np.bincount(np.asarray(topi).reshape(-1), minlength=E)
    drops += int(np.maximum(counts - C, 0).sum())
np.savez(sys.argv[2], out=np.asarray(out), aux=np.asarray(aux["moe_balance"]), drops=drops)
'''


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _moe_inputs():
    cfg = get_config("deepseek-moe-16b", reduced=True)
    rng = np.random.default_rng(7)
    moe = MoE(cfg, device="meta")
    out = {n: (rng.standard_normal(p.shape) / np.sqrt(p.shape[-2])).astype(np.float32)
           for n, p in moe.named_parameters()}
    out["x"] = rng.standard_normal((MOE_T, cfg.d_model)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def moe_inputs():
    return _moe_inputs()


@pytest.fixture(scope="module")
def groups(tmp_path_factory, moe_inputs):
    """The 4-rank and the 2-rank group, run at once (the 2-rank group
    restores the 4-rank group's checkpoint last, once it is written)."""
    work4, work2 = (str(tmp_path_factory.mktemp(n)) for n in ("four", "two"))
    h4 = dc.start(dc.four_ranks, 4, work4, CASES4, CKPT_CASE, moe_inputs, MOE_CF, timeout=300)
    h2 = dc.start(dc.two_ranks, 2, work2, CASES2, os.path.join(work4, "ckpt"), CKPT_CASE,
                  SERVE_ARCHS, LAUNCHER, timeout=300)
    try:
        four = dc.wait(h4)
    finally:
        two = dc.wait(h2)
    return (work4, four), two


@pytest.fixture(scope="module")
def four(groups):
    return groups[0]


@pytest.fixture(scope="module")
def two(groups):
    return groups[1]


def _hold_params(got, want):
    assert set(got) == set(want)
    diff = np.concatenate([np.abs(got[n] - want[n]).ravel() for n in want])
    assert diff.max() <= 5e-4, diff.max()
    assert np.quantile(diff, 0.999) <= 1e-6, np.quantile(diff, 0.999)


def _hold_case(case, results):
    arch, shape, fsdp, remat, optimizer = case
    out = results[0][case]
    for r in results[1:]:  # every rank returns the same metrics
        assert r[case]["got"] == out["got"]
    held = HELD_STEPS[optimizer]
    for i, (got, want) in enumerate(zip(out["got"], out["ref"])):
        np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-7)
        if i >= held:
            continue
        for key in ("loss", "ce_loss"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=f"step {i}: {key}")
        gn_tol = 1e-4 if arch in ISLANDS and i > 0 else 1e-5
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=gn_tol,
                                   err_msg=f"step {i}: grad_norm")
    after = PARAMS_AFTER[optimizer] - 1
    _hold_params(out["params_got"][after], out["params_ref"][after])


@pytest.mark.parametrize("case", CASES4, ids=lambda c: f"{c[0]}-{c[1]}-fsdp{int(c[2])}-"
                                                      f"remat{int(c[3])}-{c[4]}")
def test_four_ranks_train_as_one_process(four, case):
    _hold_case(case, four[1])


@pytest.mark.parametrize("case", CASES2, ids=lambda c: f"{c[0]}-{c[1]}-fsdp{int(c[2])}-"
                                                      f"remat{int(c[3])}-{c[4]}")
def test_two_ranks_train_as_one_process(two, case):
    _hold_case(case, two)


def test_expert_parallel_moe_against_the_references_shard_map(four, moe_inputs, tmp_path):
    src = tmp_path / "moe_in.npz"
    np.savez(src, **moe_inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", MOE_REFERENCE, str(src),
                           str(tmp_path / "moe_out.npz"), str(MOE_CF)],
                          capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = np.load(tmp_path / "moe_out.npz")
    out, aux, drops = four[1][0]["moe"]
    assert all(r["moe"][2] == drops for r in four[1])
    assert drops == int(want["drops"]) > 0
    scale = np.abs(want["out"]).max()
    assert np.abs(out - want["out"]).max() <= 1e-5 * scale
    np.testing.assert_allclose(aux, float(want["aux"]), rtol=1e-6)


def test_checkpoint_placements_are_the_rules(four):
    res = four[1][0]
    got, want = res["ckpt_placements"], res["ckpt_want"]
    assert got["params"] == want["params"]
    assert got["opt"]["m"] == want["opt"]["m"] and got["opt"]["v"] == want["opt"]["v"]
    assert any(pl != (Replicate(),) * 2 for pl in got["params"].values())


def _bitwise(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _bitwise(got[k], want[k])
    else:
        np.testing.assert_array_equal(got, want)


def test_checkpoint_restores_bitwise_on_one_by_two(four, two):
    tree, placements, want = two[0]["restored"]
    _bitwise(tree, four[1][0]["ckpt_tree"])
    assert placements["params"] == want["params"]
    assert placements["opt"]["m"] == want["opt"]["m"]


def test_checkpoint_restores_bitwise_in_one_process(four):
    d = os.path.join(four[0], "ckpt")
    got = restore(d, latest_step(d))
    flat = {"params": got["params"], "opt": got["opt"]}
    want = four[1][0]["ckpt_tree"]
    _bitwise({k: v.numpy() for k, v in flat["params"].items()}, want["params"])
    for m in ("m", "v"):
        _bitwise({k: v.numpy() for k, v in flat["opt"][m].items()}, want["opt"][m])
    assert int(flat["opt"]["step"]) == int(want["opt"]["step"]) == dc.STEPS


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_model_parallel_tokens_equal_one_process(two, arch):
    """``launch.serve.run --model-parallel 2`` (the flag the launcher
    refused before the mesh path) gives one process's greedy tokens, and
    the padded caches take ``cache_shardings``' placements."""
    import argparse

    args = argparse.Namespace(arch=arch, reduced=True, batch=2, prompt_len=16, gen=4, seed=0,
                              model_parallel=1, device="cpu")
    want = serve.run(args)["tokens"]
    for rank in range(2):
        tokens, placements, rules = two[rank][("serve", arch)]
        np.testing.assert_array_equal(tokens, want)
        assert placements == rules


@pytest.mark.parametrize("arch", dc.ROW_SERVE_ARCHS)
def test_serve_one_row_on_two_data_ranks_equals_one_process(two, arch):
    """One row served on a (2, 1) mesh, a batch its data ranks do not
    divide: the batch placements fall back to replication (the sharding
    rules' guard), and the tokens are one process's."""
    import argparse

    args = argparse.Namespace(arch=arch, reduced=True, batch=1, prompt_len=16, gen=4, seed=0,
                              model_parallel=1, device="cpu")
    want = serve.run(args)["tokens"]
    for rank in range(2):
        tokens, placements, rules = two[rank][("serve_row", arch)]
        np.testing.assert_array_equal(tokens, want)
        assert placements == rules


def test_psum_compressed_is_the_sum_of_round_trips(two):
    (_, rt0, s0), (_, rt1, s1) = (r["psum"] for r in two)
    np.testing.assert_array_equal(s0, s1)
    np.testing.assert_array_equal(s0, rt0 + rt1)


def test_train_launcher_model_parallel_fsdp_lowers_the_loss(two):
    """``launch.train.run --model-parallel 2 --fsdp`` on two ranks (the
    flags the launcher refused before the mesh path): a (1, 2) mesh, the
    state in the rules' placements, and the loss falls."""
    out = two[0]["launcher"]
    assert out["mesh"] == (1, 2)
    assert out["placements"] == out["want"]
    losses = out["losses"]
    assert len(losses) == 8 and losses[-1] < losses[0]
    assert two[1]["launcher"]["losses"] == losses


def test_moe_config_reduces_capacity_per_shard():
    """The capacity of the expert-parallel path is per data shard, as the
    reference's: at cf = 0.5, 32 tokens, 8 experts, top-2, two data ranks
    leave 2 slots an expert where one device would leave 4."""
    cfg = get_config("deepseek-moe-16b", reduced=True)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=MOE_CF))
    from repro_torch.models.moe import expert_capacity

    assert expert_capacity(cfg, MOE_T) == 4 and expert_capacity(cfg, MOE_T // 2) == 2
