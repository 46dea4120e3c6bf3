"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's ``launch/dryrun.py`` where the reference can be an oracle on this
JAX (its own dry run needs ``jax.make_mesh``'s Explicit axes to work, ROADMAP
C-3):

- ``model_flops`` equal to the reference's (to float64 rounding: the
  reference scales each period-stacked leaf, the port each layer's) for every
  config of ``configs/`` x every entry of ``SHAPES``, the reference on
  ``jax.eval_shape`` parameters, the port on meta tensors;
- the counted FLOPs of the reduced stablelm-3b prefill (``tools.
  cost_checks``) against ``hlocost.analyze`` of the reference's jitted
  prefill, no mesh: equal once the attention is taken in the reference's
  convention (its blocked attention computes the masked half of each
  diagonal block too), and that count is ``cost_checks.
  REFERENCE_PREFILL_FLOPS``, the number ``chip_smoke.py`` holds the card's
  torch to;
- ``argument`` bytes per device on a fake (2, 2) mesh equal to the sum of the
  local shards that the placements give;
- one full-width cell on the fake 16 x 16 mesh (stablelm-3b ``train_4k``)
  with finite terms, and reduced cells of the layouts a cell must get
  through: a batch its data ranks do not divide, a strided shard of
  flattened rows, a MoE's tokens sharded over every mesh dim;
- the tensor-parallel split of a step: the reduced qwen2.5-14b train and
  prefill steps count per device the (1, 1) mesh's count over the ranks
  (ROADMAP C-15: the SwiGLU projections ran whole on every model rank);
- ``main`` writing its JSON, a skipped cell included.
"""

import json
import math
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import all_archs as jall_archs  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import hlocost  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.configs import all_archs, get_config  # noqa: E402
from repro_torch.distributed.sharding import param_shardings  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.models.config import SHAPES  # noqa: E402
from repro_torch.tools import cost_checks  # noqa: E402


def _reference_dryrun():
    """``repro.launch.dryrun`` without its import's side effect: it appends a
    512-device flag to ``XLA_FLAGS``, which would reach a JAX backend that
    another test file starts later on this worker."""
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jdryrun
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return jdryrun


@pytest.mark.parametrize("arch", all_archs())
def test_model_flops_equal_the_references(arch):
    assert arch in jall_archs()
    jdryrun = _reference_dryrun()
    jcfg, cfg = jget_config(arch), get_config(arch)
    jparams = jax.eval_shape(lambda: jinit_params(jcfg, jax.random.PRNGKey(0)))
    params = S.abstract_params(cfg)
    for shape in SHAPES:
        want = jdryrun.model_flops(jcfg, jparams, shape)
        assert dryrun.model_flops(cfg, params, shape) == pytest.approx(want, rel=1e-12)
        # a train state reads its parameters
        assert dryrun.model_flops(cfg, {"params": params}, shape) == pytest.approx(want,
                                                                                 rel=1e-12)


def test_counted_prefill_flops_against_hlocost():
    case = cost_checks.PREFILL_CASE
    jcfg = jget_config(case["arch"], reduced=True)
    params = jax.eval_shape(lambda: jinit_params(jcfg, jax.random.PRNGKey(0)))
    batch = {"tokens": jax.ShapeDtypeStruct((case["batch"], case["seq"]), jnp.int32)}
    compiled = jax.jit(jsteps.make_prefill_step(jcfg)).lower(params, batch).compile()
    want = hlocost.analyze(compiled.as_text())["flops"]
    assert want == cost_checks.REFERENCE_PREFILL_FLOPS
    counted, in_reference_convention = cost_checks.prefill_flops()
    assert in_reference_convention == want
    assert counted < want  # the masked half of the diagonal blocks is not counted


def test_argument_bytes_are_the_local_shards():
    sh = dict(seq_len=32, global_batch=8, kind="train")
    _, info = dryrun.lower_cell("qwen2.5-14b", sh, reduced=True, mesh_shape=(2, 2))
    cfg = get_config("qwen2.5-14b", reduced=True)
    sizes = {"data": 2, "model": 2}
    params = S.abstract_params(cfg)
    rules = param_shardings(sizes, params)
    local = 0
    for name, p in params.named_parameters():
        n = p.numel()
        for axis, pl in zip(sizes, rules[name]):
            if pl.is_shard():
                n //= sizes[axis]
        local += n * p.element_size()
    # parameters and both float32 moments, the int32 step, tokens and labels
    # (batch on "data")
    want = local * 3 + 4 + 2 * (8 // 2) * 32 * 4
    assert info["per_device_bytes"]["argument"] == want
    assert info["per_device_bytes"]["peak"] > want
    assert info["n_chips"] == 4 and info["mesh"] == "2x2"


def test_full_width_cell_on_the_production_mesh():
    out, info = dryrun.lower_cell("stablelm-3b", "train_4k")
    assert out is not None and info["mesh"] == "16x16" and info["n_chips"] == 256
    r = info["roofline"]
    assert all(math.isfinite(r[k]) and r[k] > 0 for k in ("compute_s", "memory_s",
                                                         "collective_s"))
    assert r["bottleneck"] in ("compute_s", "memory_s", "collective_s")
    assert info["per_device"]["collective_gbytes"] > 0
    assert 0 < info["useful_flops_ratio"] < 1
    assert info["per_device_bytes"]["peak"] > info["per_device_bytes"]["argument"] > 0


@pytest.mark.parametrize("arch,shape,mesh", [
    # one row on two data ranks: the batch stays whole (ROADMAP C-13)
    ("jamba-v0.1-52b", "long_500k", (2, 2)),
    ("xlstm-350m", "long_500k", (2, 2)),
    # 32 rows on 16 data ranks: DTensor sizes a strided shard of the
    # flattened rows by a real arange, kept out of the fake mode
    ("stablelm-3b", "prefill_32k", (16, 16)),
    # the expert-parallel MoE's tokens, sharded over every mesh dim, viewed
    # back as (b, s) rows (ROADMAP C-14)
    ("deepseek-moe-16b", dict(seq_len=64, global_batch=2, kind="prefill"), (2, 4)),
    # four heads on eight model ranks: the attention's flat output anchored
    # on rows, so that its gradient views back to heads (C-15's anchors
    # give it sharded over "model" otherwise)
    ("qwen2.5-14b", dict(seq_len=32, global_batch=4, kind="train"), (1, 8)),
    # the same for the cross attention's q, k and v (``transformer._heads``)
    ("whisper-large-v3", dict(seq_len=32, global_batch=4, kind="train"), (1, 8)),
])
def test_reduced_cells_complete(arch, shape, mesh):
    out, info = dryrun.lower_cell(arch, shape, reduced=True, mesh_shape=mesh)
    assert out is not None and info["per_device"]["gflops"] > 0
    assert all(math.isfinite(info["roofline"][k]) for k in ("compute_s", "memory_s",
                                                          "collective_s"))


TP_CELL = dict(seq_len=32, global_batch=4)


@pytest.fixture(scope="module")
def one_rank_flops():
    """The reduced qwen2.5-14b steps' counted FLOPs on a (1, 1) mesh."""
    return {kind: dryrun.lower_cell("qwen2.5-14b", dict(TP_CELL, kind=kind), reduced=True,
                                    mesh_shape=(1, 1), remat="off")[1]["per_device"]["gflops"]
            for kind in ("train", "prefill")}


@pytest.mark.parametrize("kind,mesh,rel", [
    # every head count divides the model ranks: exactly the rank's share
    ("train", (1, 2), 1e-12), ("prefill", (1, 2), 1e-12),
    ("train", (2, 2), 1e-12), ("prefill", (2, 2), 1e-12),
    # two KV heads on four model ranks: the attention splits by rows, and the
    # counts are rank 0's, whose causal rows see fewer keys than the mean
    # (3.4 % under the share here)
    ("train", (1, 4), 0.05), ("prefill", (1, 4), 0.05),
])
def test_tensor_parallel_splits_the_step(one_rank_flops, kind, mesh, rel):
    """Per device, the mesh's count is the (1, 1) count over the ranks.
    With the residual stream left a partial sum after a row-parallel
    projection (or its gradient left partial), DTensor gathers the next
    projection's weights and runs the product whole on every model rank:
    1.19x the share at (1, 2) and (2, 2), 1.54x at (1, 4) (C-15)."""
    _, info = dryrun.lower_cell("qwen2.5-14b", dict(TP_CELL, kind=kind), reduced=True,
                                mesh_shape=mesh, remat="off")
    share = one_rank_flops[kind] / math.prod(mesh)
    assert info["per_device"]["gflops"] == pytest.approx(share, rel=rel)


def test_main_writes_json(tmp_path):
    out = tmp_path / "dryrun.json"
    assert dryrun.main(["--arch", "xlstm-350m", "--shape", "decode_32k", "--out", str(out)]) == 0
    assert dryrun.main(["--arch", "stablelm-3b", "--shape", "long_500k",
                        "--out", str(tmp_path / "skip.json")]) == 0
    (cell,) = json.loads(out.read_text())
    assert cell["arch"] == "xlstm-350m" and cell["kind"] == "decode"
    assert set(cell["roofline"]) == {"compute_s", "memory_s", "collective_s", "bottleneck"}
    (skipped,) = json.loads((tmp_path / "skip.json").read_text())
    assert "sub-quadratic" in skipped["skipped"]
