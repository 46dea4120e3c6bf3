"""The port's LM serving path (``repro_torch.models``, ``train/steps``,
``launch/serve``) against the JAX package's, from the same weights.

The reference's parameters (``init_params(cfg, PRNGKey(0))``) come across as
numpy arrays through ``convert.lm_params_from_numpy``; the reference's model
functions are called outside a mesh, as ``tests/test_archs.py`` calls them.
For each pure-text ``attn_mlp`` reduced config (stablelm_3b, qwen2_5_14b,
starcoder2_7b, starcoder2_15b), float32, rtol 1e-4 / atol 1e-5:

- ``forward`` logits at a ragged length (37, chunks of 16);
- ``prefill`` last logits and caches, then ``pad_cache`` and four
  ``decode_step``s (logits and the caches after them);
- the port's ``decode_step`` from zero caches against its own ``forward``
  (``test_archs.test_decode_matches_forward``);
- ``param_count``, and the ``attn_bidir_mlp`` block against the reference's.

The server: ``serve.run(--device cpu)`` on reduced qwen with the JAX
weights and prompts, the tokens teacher-forced from the reference's greedy
loop (its ``prefill``/``pad_cache``/``decode_step``; the reference's own
``launch/serve.run`` builds a mesh and fails on this JAX, ROADMAP C-3), and
the logits held at every step.
"""

import argparse
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as J  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
import repro_torch.models as T  # noqa: E402
from repro_torch.configs import all_archs, get_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.common import dense_init  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.train.steps import make_decode_step, make_prefill_step  # noqa: E402

TEXT_ARCHS = ["stablelm_3b", "qwen2_5_14b", "starcoder2_7b", "starcoder2_15b"]
RTOL, ATOL = 1e-4, 1e-5
KEY = jax.random.PRNGKey(0)
B, S = 2, 37


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module", params=TEXT_ARCHS)
def pair(request):
    """(the port's cfg, the reference's cfg, JAX params, the port's LM on the
    CPU with the same weights)."""
    cfg, jcfg = get_config(request.param, reduced=True), jget_config(request.param, reduced=True)
    jparams = J.init_params(jcfg, KEY)
    model = T.LM(cfg, device="cpu")
    model.load_state_dict(lm_params_from_numpy(cfg, _np(jparams), "cpu"))
    return cfg, jcfg, jparams, model


def _tokens(cfg, seed, b=B, s=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_configs_are_the_references():
    from repro.configs import all_archs as jall_archs

    assert all_archs() == jall_archs()
    for arch in all_archs():
        for reduced in (False, True):
            assert (dataclasses.asdict(get_config(arch, reduced=reduced))
                    == dataclasses.asdict(jget_config(arch, reduced=reduced)))
    assert get_config("qwen2.5-14b") == get_config("qwen2_5_14b")


def test_param_count(pair):
    cfg, jcfg, jparams, model = pair
    assert T.param_count(model) == J.param_count(jparams)


def test_forward_matches_reference(pair):
    cfg, jcfg, jparams, model = pair
    tok = _tokens(cfg, 1)
    got, _ = T.forward(cfg, model, {"tokens": torch.as_tensor(tok)})
    want, _ = J.forward(jcfg, jparams, {"tokens": jnp.asarray(tok)})
    assert got.shape == (B, S, cfg.vocab)
    _close(got, want)


def test_prefill_and_decode_match_reference(pair):
    cfg, jcfg, jparams, model = pair
    tok = _tokens(cfg, 2, s=S + 4)
    got, cache = T.prefill(cfg, model, {"tokens": torch.as_tensor(tok[:, :S])})
    want, jcache = J.prefill(jcfg, jparams, {"tokens": jnp.asarray(tok[:, :S])})
    _close(got, want)
    for key in jcache:
        for name in ("k", "v"):
            assert cache[key][name].shape == jcache[key][name].shape
            _close(cache[key][name], jcache[key][name])
    cache = T.pad_cache(cfg, cache, S + 6)
    jcache = J.pad_cache(jcfg, jcache, S + 6)
    for i in range(4):
        pos = np.full((B,), S + i, np.int32)
        got, cache = T.decode_step(cfg, model, torch.as_tensor(tok[:, S + i]),
                                   torch.as_tensor(pos), cache)
        want, jcache = J.decode_step(jcfg, jparams, jnp.asarray(tok[:, S + i]),
                                     jnp.asarray(pos), jcache)
        _close(got, want)
    for key in jcache:
        for name in ("k", "v"):
            _close(cache[key][name], jcache[key][name])


def test_decode_matches_own_forward(pair):
    cfg, _, _, model = pair
    s = 12
    tok = torch.as_tensor(_tokens(cfg, 3, s=s))
    full, _ = model.forward({"tokens": tok})
    cache = model.init_cache(B, s + 2)
    for i in range(s):
        lg, cache = model.decode_step(tok[:, i], torch.full((B,), i), cache)
        torch.testing.assert_close(lg, full[:, i], rtol=RTOL, atol=ATOL)


def test_steps_are_the_model_functions(pair):
    cfg, _, _, model = pair
    tok = torch.as_tensor(_tokens(cfg, 4, s=9))
    lg, cache = make_prefill_step(cfg)(model, {"tokens": tok})
    want, _ = model.prefill({"tokens": tok})
    assert torch.equal(lg, want)
    cache = model.pad_cache(cache, 10)
    lg, _ = make_decode_step(cfg)(model, tok[:, 0], torch.full((B,), 9), cache)
    assert lg.shape == (B, cfg.vocab) and bool(torch.isfinite(lg).all())


def test_bidir_block_matches_reference():
    cfg, jcfg = get_config("qwen2_5_14b", reduced=True), jget_config("qwen2_5_14b", reduced=True)
    jp = jtransformer.block_params("attn_bidir_mlp", KEY, jcfg, jnp.float32)
    blk = ttransformer.Block(cfg, "attn_bidir_mlp", device="cpu")
    state = {f"{sub}.{name}": torch.as_tensor(np.asarray(x))
             for sub, leaves in _np(jp).items() for name, x in leaves.items()}
    blk.load_state_dict(state)
    x = np.random.default_rng(5).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    positions = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    got, cache, _ = blk.apply_seq(torch.as_tensor(x), torch.as_tensor(positions), mode="train")
    want, _, _ = jtransformer.block_apply_seq(jcfg, "attn_bidir_mlp", jp, jnp.asarray(x),
                                              jnp.asarray(positions), mode="train")
    assert cache is None
    _close(got, want)
    with pytest.raises(ValueError):
        blk.apply_decode(torch.as_tensor(x[:, 0]), torch.zeros(B, dtype=torch.long), {})


def test_bf16_weights_carry_across_exactly():
    cfg = dataclasses.replace(get_config("qwen2_5_14b", reduced=True), dtype="bfloat16")
    jparams = J.init_params(dataclasses.replace(jget_config("qwen2_5_14b", reduced=True),
                                                dtype="bfloat16"), KEY)
    state = lm_params_from_numpy(cfg, _np(jparams), "cpu")
    assert state["embed"].dtype == torch.bfloat16
    assert state["final_norm._scale"].dtype == torch.float32  # norms stay float32
    wq = np.asarray(jparams["blocks"]["b0"]["attn"]["wq"][1], np.float32)
    np.testing.assert_array_equal(state["blocks.1.attn.wq"].float().numpy(), wq)
    model = T.LM(cfg, device="cpu")
    model.load_state_dict(state)
    lg, _ = model.prefill({"tokens": torch.as_tensor(_tokens(cfg, 6, s=8))})
    assert lg.dtype == torch.bfloat16 and bool(torch.isfinite(lg).all())


def test_init_params_is_seeded_and_scaled():
    cfg = get_config("qwen2_5_14b", reduced=True)
    a, b = T.init_params(cfg, 3, "cpu"), T.init_params(cfg, 3, "cpu")
    for (name, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), name
    wq = a.blocks[0].attn["wq"]
    assert abs(float(wq.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.05
    assert abs(float(a.embed.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.05
    assert all(p.requires_grad for p in a.parameters())  # trainable (train.steps)
    c = T.LM(cfg, device="cpu").init_params(3)  # the method draws the same weights
    for (name, x), (_, y) in zip(a.state_dict().items(), c.state_dict().items()):
        assert torch.equal(x, y), name
    w = dense_init(torch.Generator().manual_seed(0), (400, 300))
    assert w.shape == (400, 300) and abs(float(w.std()) * 20.0 - 1.0) < 0.05


def _args(**kw):
    base = dict(arch="qwen2.5-14b", reduced=True, batch=2, prompt_len=12, gen=5, seed=0,
                model_parallel=1, device="cpu")
    return argparse.Namespace(**{**base, **kw})


def test_serve_matches_reference_loop():
    args = _args()
    cfg, jcfg = get_config(args.arch, reduced=True), jget_config(args.arch, reduced=True)
    jparams = J.init_params(jcfg, KEY)
    prompts = _tokens(cfg, 7, b=args.batch, s=args.prompt_len)
    # The reference's greedy loop (launch/serve.run without its mesh).
    jlogits, jcache = J.prefill(jcfg, jparams, {"tokens": jnp.asarray(prompts)})
    jcache = J.pad_cache(jcfg, jcache, args.prompt_len + args.gen)
    want = [np.asarray(jlogits)]
    tok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    fed = [np.asarray(tok)]
    for i in range(args.gen - 1):
        pos = jnp.full((args.batch,), args.prompt_len + i, jnp.int32)
        jlogits, jcache = J.decode_step(jcfg, jparams, tok, pos, jcache)
        want.append(np.asarray(jlogits))
        tok = jnp.argmax(jlogits, -1).astype(jnp.int32)
        fed.append(np.asarray(tok))
    feed = np.stack(fed, 1)

    model = T.LM(cfg, device="cpu")
    model.load_state_dict(lm_params_from_numpy(cfg, _np(jparams), "cpu"))
    got = {}
    out = serve.run(args, model=model, prompts=prompts, feed=feed,
                    record=lambda step, lg: got.__setitem__(step, lg.clone()))
    assert sorted(got) == list(range(args.gen))
    for step in range(args.gen):
        _close(got[step], want[step])
    assert set(out) == {"prefill_s", "decode_s", "tokens"}
    assert out["tokens"].shape == (args.batch, args.gen)
    np.testing.assert_array_equal(out["tokens"], feed)  # greedy == the reference's tokens


def test_serve_draws_its_own_weights_on_the_cpu():
    out = serve.main(["--device", "cpu", "--arch", "stablelm-3b", "--batch", "2",
                      "--prompt-len", "8", "--gen", "3"])
    assert out["tokens"].shape == (2, 3)
    assert ((0 <= out["tokens"]) & (out["tokens"] < 256)).all()


def test_serve_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.run(_args(device="cuda"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_params(get_config("qwen2_5_14b", reduced=True), 0)
