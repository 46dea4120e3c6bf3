"""Checkpointing, resume and fault tolerance of the port's training path
(``repro_torch.checkpoint``, ``launch/train``, ``launch/fault_tolerance``),
and the checkpoint format against the JAX package's.

- ``save``/``restore``: a tree of float32, bfloat16, int8 and int32 leaves
  round-trips bitwise with its dtypes; ``restore`` without a like-tree
  rebuilds the nested dicts from the manifest's paths.
- Atomicity: a write that fails half-way leaves neither a temporary nor a
  step directory; a finished save leaves no temporary directory.
- ``CheckpointManager``: retention (keep 2 of 4) and the async save's host
  copy, taken before ``save_async`` returns (the tensor is changed in place
  while the write waits, and the checkpoint holds the values at the call).
- The format: the same numpy tree saved by the reference's ``save`` and the
  port's gives the same manifest and arrays; a train state saved by the
  reference's ``checkpoint.save`` and restored through
  ``convert.train_state_from_numpy`` gives the reference's loss (1e-5).
- Resume: N train steps, or N/2 then a checkpoint, a fresh state restored
  from it and N/2 more, bitwise equal (parameters, moments, losses); the
  launcher resumes from its latest checkpoint.
- ``Watchdog`` and ``RestartPolicy`` as ``tests/test_system.py`` holds the
  reference's.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, latest_step, restore, save  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import train_state_from_numpy  # noqa: E402
from repro_torch.data import SyntheticTokens  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.launch.fault_tolerance import RestartPolicy, StepTimeout, Watchdog  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train import cross_entropy_loss, init_train_state, make_train_step  # noqa: E402


def _tree():
    return {"a": torch.arange(10.0),
            "b": {"c": torch.randn(3, 4, generator=torch.Generator().manual_seed(0))
                  .to(torch.bfloat16),
                  "q": torch.tensor([-127, 0, 5, 127], dtype=torch.int8)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _equal(got[k], want[k])
    else:
        assert got.dtype == want.dtype and torch.equal(got, want)


class TestStore:
    def test_roundtrip(self, tmp_path):
        tree = _tree()
        save(str(tmp_path), 7, tree)
        assert latest_step(str(tmp_path)) == 7
        _equal(restore(str(tmp_path), 7, tree), tree)
        _equal(restore(str(tmp_path), 7), tree)  # rebuilt from the manifest's paths
        manifest = json.load(open(tmp_path / "step_00000007" / "manifest.json"))
        assert manifest["names"] == ["a", "b/c", "b/q", "step"]
        assert manifest["dtypes"] == ["float32", "bfloat16", "int8", "int32"]

    def test_restore_refuses_another_tree(self, tmp_path):
        save(str(tmp_path), 1, _tree())
        with pytest.raises(ValueError, match="does not hold"):
            restore(str(tmp_path), 1, {"a": torch.zeros(10)})

    def test_atomicity_no_partial_dirs(self, tmp_path, monkeypatch):
        save(str(tmp_path), 1, {"a": torch.zeros(4)})
        assert [d for d in os.listdir(tmp_path) if not d.startswith("step_")] == []

        def crash(f, **arrays):
            f.write(b"half a file")
            raise OSError("disk lost mid-write")

        monkeypatch.setattr(store.np, "savez", crash)
        with pytest.raises(OSError, match="mid-write"):
            save(str(tmp_path), 2, {"a": torch.ones(4)})
        assert sorted(os.listdir(tmp_path)) == ["step_00000001"]
        assert latest_step(str(tmp_path)) == 1

    def test_manager_async_and_retention(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        tree = {"w": torch.ones(8)}
        for s in (1, 2, 3, 4):
            mgr.save_async(s, tree)
        mgr.wait()
        mgr.close()
        assert sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)) == [3, 4]

    def test_async_save_copies_to_host_before_returning(self, tmp_path, monkeypatch):
        release = threading.Event()
        write = store._write

        def held_write(*args):
            release.wait(10)
            return write(*args)

        monkeypatch.setattr(store, "_write", held_write)
        mgr = CheckpointManager(str(tmp_path), keep=2)
        w = torch.arange(6.0)
        mgr.save_async(5, {"w": w})
        w.add_(100.0)  # the next optimizer step, in place
        release.set()
        mgr.wait()
        mgr.close()
        _equal(restore(str(tmp_path), 5), {"w": torch.arange(6.0)})

    def test_same_format_as_reference(self, tmp_path):
        rng = np.random.default_rng(0)
        tree = {"params": {"w": rng.standard_normal((3, 5)).astype(np.float32),
                           "blocks": {"b0": {"x": rng.standard_normal(4).astype(np.float32)}}},
                "opt": {"step": np.int32(3)}}
        jckpt.save(str(tmp_path / "ref"), 3, jax.tree_util.tree_map(jnp.asarray, tree))
        save(str(tmp_path / "port"), 3, tree)
        assert (json.load(open(tmp_path / "ref" / "step_00000003" / "manifest.json"))
                == json.load(open(tmp_path / "port" / "step_00000003" / "manifest.json")))
        ref = np.load(tmp_path / "ref" / "step_00000003" / "arrays.npz")
        port = np.load(tmp_path / "port" / "step_00000003" / "arrays.npz")
        assert sorted(ref.files) == sorted(port.files)
        for key in ref.files:
            np.testing.assert_array_equal(ref[key], port[key])


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()


@pytest.mark.parametrize("optimizer", ["adamw", "adamw8bit"])
def test_reference_checkpoint_restores_to_the_same_loss(tmp_path, optimizer):
    jcfg, cfg = jget_config("stablelm-3b", reduced=True), get_config("stablelm-3b", reduced=True)
    jstate = jsteps.init_train_state(jcfg, jax.random.PRNGKey(1), optimizer=optimizer)
    jckpt.save(str(tmp_path), 0, jstate)
    state = train_state_from_numpy(cfg, _numpy(restore(str(tmp_path), 0)), "cpu")
    batch = SyntheticTokens(vocab=cfg.vocab, seq_len=24, global_batch=2).batch(0)
    jlogits, _ = jforward(jcfg, jstate["params"], {"tokens": jnp.asarray(batch["tokens"])})
    want = jsteps.cross_entropy_loss(jlogits, jnp.asarray(batch["labels"]))
    with torch.no_grad():
        logits, _ = state["params"].forward({"tokens": torch.as_tensor(batch["tokens"])})
    got = cross_entropy_loss(logits, torch.as_tensor(batch["labels"]))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert int(state["opt"]["step"]) == 0
    leaf = state["opt"]["m"]["blocks.0.attn.wq"]
    assert (leaf["q"].dtype == torch.int8) if optimizer == "adamw8bit" else \
        (leaf.dtype == torch.float32)


@pytest.mark.parametrize("optimizer", ["adamw", "adamw8bit"])
def test_resume_is_bitwise(tmp_path, optimizer):
    """N steps straight, or N/2, a checkpoint, a fresh state restored from
    it and N/2 more: the same bits."""
    n = 4
    cfg = get_config("stablelm-3b", reduced=True)
    ds = SyntheticTokens(vocab=cfg.vocab, seq_len=24, global_batch=2)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=n),
                           optimizer=optimizer)

    def steps(state, lo, hi):
        losses = []
        for i in range(lo, hi):
            state, m = step(state, {k: torch.as_tensor(v) for k, v in ds.batch(i).items()})
            losses.append(float(m["loss"]))
        return state, losses

    straight, losses = steps(init_train_state(cfg, 0, optimizer=optimizer, device="cpu"), 0, n)
    half, first = steps(init_train_state(cfg, 0, optimizer=optimizer, device="cpu"), 0, n // 2)
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save_async(n // 2 - 1, tlaunch.state_tree(half))
    mgr.wait()
    mgr.close()
    fresh = init_train_state(cfg, 1, optimizer=optimizer, device="cpu")  # other weights
    tlaunch.load_state(fresh, restore(str(tmp_path), latest_step(str(tmp_path)),
                                      tlaunch.state_tree(fresh)))
    resumed, second = steps(fresh, n // 2, n)
    assert first + second == losses
    _equal(tlaunch.state_tree(resumed), tlaunch.state_tree(straight))


def test_launcher_resumes_from_latest_checkpoint(tmp_path):
    base = ["--arch", "stablelm-3b", "--batch", "2", "--seq", "24", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2", "--log-every", "100"]
    out1 = tlaunch.run(tlaunch.parser().parse_args(base + ["--steps", "4"]))
    assert out1["start"] == 0 and latest_step(str(tmp_path)) == 3
    out2 = tlaunch.run(tlaunch.parser().parse_args(base + ["--steps", "6"]))
    assert out2["start"] == 4 and len(out2["losses"]) == 2
    assert sorted(os.listdir(tmp_path)) == ["step_00000004", "step_00000005"]


class TestFaultTolerance:
    def test_watchdog_passes_fast_steps(self):
        out = Watchdog(timeout_s=5.0).run(lambda x: x + 1, torch.ones(4))
        assert torch.equal(out, torch.full((4,), 2.0))

    def test_watchdog_kills_hung_step(self):
        with pytest.raises(StepTimeout):
            Watchdog(timeout_s=0.2).run(lambda: time.sleep(2.0))

    def test_restart_policy_retries_then_succeeds(self):
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise RuntimeError("simulated node failure")
            return "ok"

        assert RestartPolicy(max_restarts=3, backoff_s=0.01).supervise(flaky) == "ok"
        assert calls["n"] == 3

    def test_restart_policy_gives_up(self):
        def dead():
            raise RuntimeError("hard failure")

        with pytest.raises(RuntimeError):
            RestartPolicy(max_restarts=1, backoff_s=0.01).supervise(dead)
