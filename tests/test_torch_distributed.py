"""The port's ``distributed/`` and ``launch/{mesh,specs}`` against the JAX
package's, on the CPU, without a process group where none is needed.

- The sharding rules, leaf by leaf: for every config of ``configs/`` at full
  width (on the meta device) and the meshes (1, 1), (2, 4), (4, 2) over
  ("data", "model") and (2, 2, 2) over ("pod", "data", "model"), the port's
  ``param_shardings`` (fsdp on and off), ``state_shardings`` for AdamW and
  8-bit moments, ``cache_shardings`` of the decode_32k cache and
  ``batch_spec`` of the train_4k and long_500k batches give each leaf the
  reference's ``PartitionSpec`` (the port's placements read back by
  ``to_logical``; each entry as a tuple of axis names).  The reference runs
  in a subprocess with ``--xla_force_host_platform_device_count=8`` under
  ``jax.sharding.Mesh`` (``jax.make_mesh`` gives Explicit axes on JAX 0.9,
  ROADMAP C-3); the reference's stacked leaves carry a leading period axis,
  which each of the port's per-layer leaves drops.
- The constraints (the reference's ``TestConstraints``): ``constrain`` is
  the identity outside a mapping and for a plain tensor, ``tp_size`` is
  visible only inside one, and on a mesh of one it redistributes a
  DTensor (a gloo group of this process, destroyed after).
- Compression against the reference on the same numpy inputs: the int8
  payload and scales bitwise over a hypothesis strategy of shapes (ragged
  tails included), the round trip, and error feedback over three steps.
  ``psum_compressed`` on two ranks is in ``test_torch_distributed_ranks.py``.
- ``repro_torch.distributed.__all__`` is the reference's, and
  ``launch.mesh`` / ``launch.specs`` have the reference's public functions;
  the specs allocate nothing.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.distributed as jdist  # noqa: E402
import repro.launch.specs as jspecs  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.distributed import constraints as jcons  # noqa: E402
import repro_torch.distributed as tdist  # noqa: E402
from repro_torch.configs import all_archs, get_config  # noqa: E402
from repro_torch.distributed import compression as tcomp  # noqa: E402
from repro_torch.distributed import constraints as tcons  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    batch_spec,
    cache_shardings,
    dp_axes,
    param_shardings,
    state_shardings,
    to_logical,
)
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402

MESHES = {"1x1": (("data", "model"), (1, 1)), "2x4": (("data", "model"), (2, 4)),
          "4x2": (("data", "model"), (4, 2)), "pod2x2x2": (("pod", "data", "model"), (2, 2, 2))}

REFERENCE = r'''
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import all_archs, get_config
from repro.distributed.sharding import batch_spec, cache_shardings, param_shardings, state_shardings
from repro.launch import specs

MESHES = json.loads(sys.argv[1])

def norm(spec):
    return [[] if a is None else [a] if isinstance(a, str) else list(a) for a in spec]

def flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: hasattr(x, "spec"))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path): norm(s.spec)
            for path, s in leaves}

out = {}
for arch in all_archs():
    cfg = get_config(arch)
    params = specs.abstract_params(cfg)
    states = {opt: specs.abstract_train_state(cfg, opt) for opt in ("adamw", "adamw8bit")}
    cache = specs.decode_specs(cfg, "decode_32k")[2]
    batches = {"train_4k": specs.batch_specs(cfg, "train_4k", with_labels=True),
               "long_500k": specs.batch_specs(cfg, "long_500k", with_labels=False)}
    out[arch] = {}
    for key, (axes, shape) in MESHES.items():
        n = int(np.prod(shape))
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), tuple(axes))
        r = {"params_fsdp": flat(param_shardings(mesh, params, fsdp=True)),
             "params": flat(param_shardings(mesh, params, fsdp=False)),
             "cache": flat(cache_shardings(mesh, cache))}
        for opt, st in states.items():
            r[opt] = flat(state_shardings(mesh, st, fsdp=True))
        for name, b in batches.items():
            r["batch_" + name] = {k: norm(batch_spec(mesh, v).spec) for k, v in b.items()}
        out[arch][key] = r
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REFERENCE, json.dumps(MESHES)],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout)


def _logical(mesh, placements, ndim):
    return [list(a) for a in to_logical(mesh, placements, ndim)]


def _port_name(cfg, path):
    """The port's names of a reference leaf path (several for a stacked
    leaf: one per period) and whether the reference's spec carries the
    period axis first."""
    parts = path.split("/")
    if parts[0] in ("blocks", "enc_blocks"):
        n = len(cfg.pattern) if parts[0] == "blocks" else 1
        i = int(parts[1][1:])
        rest = ".".join(parts[2:])
        return [f"{parts[0]}.{p * n + i}.{rest}" for p in range(cfg.n_periods)], True
    return [".".join(parts)], False


def _hold_tree(cfg, mesh, want, got_specs, shapes):
    """Every reference leaf's spec (period axis dropped) equals the port's
    for each of the port's leaves it stands for, and no port leaf is left
    over."""
    seen = set()
    for path, spec in want.items():
        names, stacked = _port_name(cfg, path)
        for name in names:
            assert name in got_specs, name
            got = _logical(mesh, got_specs[name], len(shapes[name]))
            assert got == (spec[1:] if stacked else spec), (name, got, spec)
            seen.add(name)
    assert seen == set(got_specs)


def _flat_moments(tree):
    out = {}
    for name, x in tree.items():
        if isinstance(x, dict):
            out.update({f"{name}.{k}": v for k, v in x.items()})
        else:
            out[name] = x
    return out


@pytest.fixture(scope="module")
def port_trees():
    """Per config: the meta LM's parameter shapes, both optimizers' meta
    states, the decode_32k meta cache and the batches."""
    out = {}
    for arch in all_archs():
        cfg = get_config(arch)
        states = {opt: tspecs.abstract_train_state(cfg, opt) for opt in ("adamw", "adamw8bit")}
        out[arch] = dict(cfg=cfg, states=states, cache=tspecs.decode_specs(cfg, "decode_32k")[2],
                         batches={"train_4k": tspecs.batch_specs(cfg, "train_4k", with_labels=True),
                                  "long_500k": tspecs.batch_specs(cfg, "long_500k",
                                                                  with_labels=False)})
    return out


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", all_archs())
def test_rules_equal_the_references_leaf_by_leaf(reference, port_trees, arch, mesh_key):
    axes, shape = MESHES[mesh_key]
    mesh = dict(zip(axes, shape))
    want, t = reference[arch][mesh_key], port_trees[arch]
    cfg, params = t["cfg"], t["states"]["adamw"]["params"]
    shapes = {n: p.shape for n, p in params.named_parameters()}
    for fsdp, key in ((True, "params_fsdp"), (False, "params")):
        _hold_tree(cfg, mesh, want[key], param_shardings(mesh, params, fsdp=fsdp), shapes)
    for opt, state in t["states"].items():
        sh = state_shardings(mesh, state, fsdp=True)
        ref = want[opt]
        _hold_tree(cfg, mesh, {p[len("params/"):]: s for p, s in ref.items()
                               if p.startswith("params/")}, sh["params"], shapes)
        for m in ("m", "v"):
            leaves = _flat_moments(state["opt"][m])
            _hold_tree(cfg, mesh, {p[len(f"opt/{m}/"):]: s for p, s in ref.items()
                                   if p.startswith(f"opt/{m}/")},
                       _flat_moments(sh["opt"][m]), {n: x.shape for n, x in leaves.items()})
        assert _logical(mesh, sh["opt"]["step"], 0) == ref["opt/step"] == []
    cache_sh = cache_shardings(mesh, t["cache"])
    for path, spec in want["cache"].items():
        key, name = path.split("/")
        assert _logical(mesh, cache_sh[key][name], t["cache"][key][name].ndim) == spec, path
    assert sorted(want["cache"]) == sorted(f"{k}/{n}" for k, c in t["cache"].items() for n in c)
    for cell, batch in t["batches"].items():
        for name, x in batch.items():
            assert _logical(mesh, batch_spec(mesh, x), x.ndim) == want["batch_" + cell][name]


def test_leaf_names_cover_the_8bit_moments():
    """A moment's q / s leaf takes its parameter's rule on its own shape:
    stablelm's wq (64, 64) pads to q (64, 256), whose last dim shards over
    "model" = 4, and its scales s (64, 1) do not divide and stay whole."""
    cfg = get_config("stablelm-3b", reduced=True)
    state = tspecs.abstract_train_state(cfg, "adamw8bit")
    sh = state_shardings({"data": 1, "model": 4}, state, fsdp=False)
    mesh = {"data": 1, "model": 4}
    wq = sh["opt"]["m"]["blocks.0.attn.wq"]
    assert _logical(mesh, wq["q"], 2) == [[], ["model"]]
    assert _logical(mesh, wq["s"], 2) == [[], []]


class TestExports:
    def test_all_equals_the_references(self):
        assert tdist.__all__ == jdist.__all__

    def test_launch_modules_have_the_references_functions(self):
        import repro.launch.mesh as jmesh

        for mod, ref in ((tmesh, jmesh), (tspecs, jspecs)):
            names = {n for n in vars(ref) if not n.startswith("_") and callable(vars(ref)[n])
                     and getattr(vars(ref)[n], "__module__", "") == ref.__name__}
            assert names <= set(vars(mod)), names - set(vars(mod))

    def test_abstract_8bit_moments_are_qadamw_inits(self):
        from repro_torch.optim.quantized import qadamw_init

        cfg = get_config("jamba-v0.1-52b", reduced=True)
        state = tspecs.abstract_train_state(cfg, "adamw8bit")
        want = qadamw_init({n: torch.zeros(p.shape, dtype=p.dtype)
                            for n, p in state["params"].named_parameters()})
        for m in ("m", "v"):
            for name, buf in want[m].items():
                for part in ("q", "s"):
                    got = state["opt"][m][name][part]
                    assert (got.shape, got.dtype) == (buf[part].shape, buf[part].dtype), name
        assert state["opt"]["step"].dtype == want["step"].dtype

    def test_specs_allocate_nothing(self):
        cfg = get_config("kimi-k2-1t-a32b")
        state = tspecs.abstract_train_state(cfg, "adamw")
        assert all(p.is_meta for p in state["params"].parameters())
        assert sum(p.numel() for p in state["params"].parameters()) > 1e12
        tok, pos, cache = tspecs.decode_specs(cfg, "decode_32k")
        assert tok.is_meta and pos.is_meta and all(t.is_meta for c in cache.values()
                                                   for t in c.values())
        for arch in all_archs():
            for cell in ("train_4k", "long_500k"):
                assert tspecs.cell_runnable(get_config(arch), cell) == jspecs.cell_runnable(
                    jget_config(arch), cell)

    def test_dp_axes(self):
        assert dp_axes({"data": 2, "model": 1}) == ("data",)
        assert dp_axes({"pod": 2, "data": 2, "model": 2}) == ("pod", "data")


class TestConstraints:
    def test_noop_outside_context(self):
        x = torch.ones((4, 4))
        assert tcons.constrain(x, "dp", None) is x
        assert jcons.constrain(jnp.ones((4, 4)), "dp", None) is not None

    def test_noop_for_a_plain_tensor_inside(self):
        x = torch.ones((4, 4))
        with tcons.activation_sharding(dp=("data",), tp="model", tp_size=2):
            assert tcons.constrain(x, "dp", None) is x

    def test_tp_size_visibility(self):
        assert tcons.tp_size() is None and tcons.current_mesh() is None
        with tcons.activation_sharding(dp=("data",), tp="model", tp_size=7):
            assert tcons.tp_size() == 7
            assert tcons.logical_axes() == (("data",), "model")
        assert tcons.tp_size() is None
        assert tcons.logical_axes() == (None, None)

    def test_constrain_applies_inside_a_mesh_of_one(self, tmp_path):
        """On a mesh of one (a gloo group of this process, destroyed after)
        ``constrain`` redistributes a DTensor to the logical spec, and the
        anchors leave the values as they are."""
        import torch.distributed as dist
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor

        dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                                world_size=1)
        try:
            mesh = tmesh.make_local_mesh(model=1, device="cpu")
            x = distribute_tensor(torch.ones((4, 4)), mesh, (Replicate(), Shard(1)))
            with tcons.activation_sharding(dp=("data",), tp="model", tp_size=1, mesh=mesh):
                y = tcons.constrain(x, "dp", None) * 2
                assert tuple(y.placements) == (Shard(0), Replicate())
                assert tcons.constrain(y, "dp", None) is y
            np.testing.assert_array_equal(y.full_tensor().numpy(), 2.0)
        finally:
            dist.destroy_process_group()


class TestCompression:
    @pytest.mark.parametrize("shape", [(1,), (255,), (256,), (257,), (3, 100), (2, 3, 129)])
    def test_quantize_bitwise_on_ragged_tails(self, shape):
        x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32) * 3
        self._hold(x)

    def test_quantize_bitwise_property(self):
        hypothesis = pytest.importorskip("hypothesis")
        from hypothesis import given, settings
        from hypothesis import strategies as st

        @settings(max_examples=12, deadline=None, derandomize=True)
        @given(st.lists(st.integers(1, 300), min_size=1, max_size=3), st.integers(0, 2**31 - 1),
               st.sampled_from([1e-3, 1.0, 1e3]))
        def check(shape, seed, scale):
            x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
            self._hold(x)

        del hypothesis
        check()

    @staticmethod
    def _hold(x):
        qj, sj = jcomp.quantize_int8(jnp.asarray(x))
        qt, st_ = tcomp.quantize_int8(torch.as_tensor(x))
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(st_.numpy(), np.asarray(sj))
        np.testing.assert_array_equal(tcomp.compress_roundtrip(torch.as_tensor(x)).numpy(),
                                      np.asarray(jcomp.compress_roundtrip(jnp.asarray(x))))

    def test_round_half_to_even(self):
        # 0.5 and 1.5 steps of the scale: both frameworks round half to even
        x = np.zeros(256, np.float32)
        x[0], x[1], x[2] = 127.0, 0.5, 1.5
        self._hold(x)
        q, _ = tcomp.quantize_int8(torch.as_tensor(x))
        assert q[0, 1] == 0 and q[0, 2] == 2

    def test_error_feedback_three_steps(self):
        rng = np.random.default_rng(0)
        shapes = {"a": (7, 300), "b": (513,)}
        ef_j = jcomp.init_error_feedback({k: jnp.zeros(s) for k, s in shapes.items()})
        ef_t = tcomp.init_error_feedback({k: torch.zeros(s) for k, s in shapes.items()})
        for _ in range(3):
            g = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
            cj, ef_j = jcomp.grads_with_error_feedback({k: jnp.asarray(v) for k, v in g.items()},
                                                       ef_j)
            ct, ef_t = tcomp.grads_with_error_feedback({k: torch.as_tensor(v)
                                                        for k, v in g.items()}, ef_t)
            for k in shapes:
                np.testing.assert_array_equal(ct[k].numpy(), np.asarray(cj[k]))
                np.testing.assert_array_equal(ef_t[k].numpy(), np.asarray(ef_j[k]))
