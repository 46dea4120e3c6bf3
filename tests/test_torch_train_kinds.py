"""One training step of every block kind beyond the dense decoder against the
JAX package's, from the same state (the CPU half of training through the
kinds; ``tests/test_torch_train.py``'s ``arch_case`` holds stablelm-3b and
qwen2.5-14b over three steps).

For the reduced deepseek-moe-16b, kimi-k2 (MoE: the balance loss enters the
loss at the step's 0.01), jamba (Mamba + attention + MoE), xlstm-350m
(mLSTM, sLSTM), whisper-large-v3 (encoder-decoder: ``audio_embeds`` in the
batch) and llava-next-34b (``img_embeds``), with remat on and off: the
port's ``make_train_step`` against the reference's jitted one from the
reference's initial state (``convert.train_state_from_numpy``), one AdamW
step on the same batch (the reference's step without remat: see
``_reference``) (``SyntheticTokens``, the frontend embeddings drawn
with numpy at the reference's 0.02 scale, as its ``tests/test_archs.py::
make_batch`` adds them).  Loss, cross entropy, the balance loss and the
gradient norm within 1e-5 relative (they agree to <= 6.7e-7), lr within
1e-7.  The 8-bit moments on deepseek-moe-16b, the same step.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import train_state_from_numpy  # noqa: E402
from repro_torch.data import SyntheticTokens  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

KINDS = ["deepseek-moe-16b", "kimi-k2-1t-a32b", "jamba-v0.1-52b", "xlstm-350m",
         "whisper-large-v3", "llava-next-34b"]
B, S = 2, 24
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@functools.lru_cache(maxsize=None)
def _reference(arch, optimizer):
    """The reference's initial train state as numpy (its init jitted: eager,
    it compiles op by op) and the metrics of its jitted step without remat
    on ``_batch``.  Both remat settings of the port are held to them: the
    reference's remat changes only what its backward recomputes, not the
    values (its own ``test_remat_matches_no_remat``), and each setting's
    compile takes ~10 s for jamba."""
    jcfg = jget_config(arch, reduced=True)
    state = jax.jit(lambda: jsteps.init_train_state(jcfg, jax.random.PRNGKey(0),
                                                    optimizer=optimizer))()
    state_np = jax.tree_util.tree_map(np.asarray, state)
    jstep = jax.jit(jsteps.make_train_step(jcfg, JAdamWConfig(**OPT), optimizer=optimizer))
    _, jm = jstep(state, {k: jnp.asarray(v) for k, v in _batch(get_config(arch, True)).items()})
    return state_np, {k: float(v) for k, v in jm.items()}


def _batch(cfg):
    batch = SyntheticTokens(vocab=cfg.vocab, seq_len=S, global_batch=B).batch(0)
    rng = np.random.default_rng(3)
    if cfg.n_img_tokens:
        batch["img_embeds"] = (rng.standard_normal((B, cfg.n_img_tokens, cfg.d_model))
                               * 0.02).astype(np.float32)
    if cfg.enc_dec:
        batch["audio_embeds"] = (rng.standard_normal((B, S, cfg.d_model)) * 0.02).astype(
            np.float32)
    return batch


@pytest.mark.parametrize("optimizer,remat,arch",
                         [("adamw", remat, arch) for arch in KINDS for remat in (False, True)]
                         + [("adamw8bit", False, "deepseek-moe-16b")])
def test_one_step_matches_reference(arch, remat, optimizer):
    cfg = get_config(arch, reduced=True)
    state_np, jm = _reference(arch, optimizer)
    state = train_state_from_numpy(cfg, state_np, "cpu")
    batch = _batch(cfg)
    step = make_train_step(cfg, AdamWConfig(**OPT), remat=remat, optimizer=optimizer)
    _, m = step(state, {k: torch.as_tensor(v) for k, v in batch.items()})
    keys = ["loss", "ce_loss", "grad_norm"] + (["moe_balance"] if cfg.moe is not None else [])
    assert set(keys) <= set(m) and set(keys) <= set(jm)
    for key in keys:
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-7)
    assert int(state["opt"]["step"]) == int(state_np["opt"]["step"]) + 1
