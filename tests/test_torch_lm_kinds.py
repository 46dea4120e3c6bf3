"""The port's LM at the block kinds beyond the dense decoder -- MoE
(deepseek-moe-16b, kimi-k2), the Mamba/attention/MoE hybrid (jamba),
xLSTM (xlstm-350m), the encoder-decoder with cross attention
(whisper-large-v3) and image tokens (llava-next-34b) -- against the JAX
package's, from the same weights.

The reference's parameters (``init_params(cfg, PRNGKey(0))``) come across as
numpy arrays through ``convert.lm_params_from_numpy``; the frontend
embeddings are drawn with numpy; the reference's model functions are called
outside a mesh, as ``tests/test_archs.py`` calls them.  For each of the six
reduced configs, float32, rtol 1e-4 / atol 1e-5 (jamba and xlstm: atol
1e-4, see ``ATOL``):

- ``param_count``;
- ``forward`` logits and aux (``moe_balance``), with and without remat;
- ``prefill`` last logits and every cache entry, ``pad_cache``, then four
  ``decode_step``s (logits and the caches after them);
- the port's ``decode_step`` from ``init_cache`` against its own
  ``forward`` (``test_archs.test_decode_matches_forward``, for the configs
  it takes, at its 2e-2);
- whisper's prefill/decode consistency, llava's prefill against forward and
  its image tokens changing the output (``test_archs.py``);
- ``serve.run(--device cpu)`` teacher-forced against the reference's
  prefill/decode loop for reduced deepseek, jamba, whisper and llava (the
  reference's own ``launch/serve.run`` builds a mesh and fails on this JAX,
  ROADMAP C-3), and every config of ``configs/`` served;
- bf16 jamba and xlstm through the converter, the reference's float32
  leaves kept float32;
- ``frontends``: shapes, dtype, scale, the same seed the same embeddings.
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
import repro_torch.models as T  # noqa: E402
from repro_torch.configs import all_archs, get_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import frontends  # noqa: E402
from repro_torch.train.steps import make_prefill_step  # noqa: E402

KIND_ARCHS = ["deepseek_moe_16b", "kimi_k2_1t_a32b", "jamba_v0_1_52b", "xlstm_350m",
              "whisper_large_v3", "llava_next_34b"]
DECODE_ARCHS = ["deepseek_moe_16b", "kimi_k2_1t_a32b", "jamba_v0_1_52b", "xlstm_350m"]
RTOL = 1e-4
# The float32 rule is rtol 1e-4 / atol 1e-5.  Jamba's and xlstm's reduced
# stacks amplify rounding past it: the reference's own logits move by up to
# 2.3e-5 (jamba) and 7.8e-5 (xlstm) when each entry of its embedding moves by
# one ulp (9 and 20 entries past the rule at these tests' tokens), while each
# layer's output stays within ~5e-7 of the reference's relative to the
# residual stream's size.  Those two are held at atol 1e-4.
ATOL = {"jamba-reduced": 1e-4, "xlstm-350m-reduced": 1e-4}
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


def _load(cfg, jparams):
    model = T.LM(cfg, device="cpu")
    model.load_state_dict(lm_params_from_numpy(cfg, _np(jparams), "cpu"))
    return model


@pytest.fixture(scope="module", params=KIND_ARCHS)
def pair(request):
    """(the port's cfg, the reference's cfg, JAX params, the port's LM on the
    CPU with the same weights)."""
    cfg, jcfg = get_config(request.param, reduced=True), jget_config(request.param, reduced=True)
    jparams = J.init_params(jcfg, KEY)
    return cfg, jcfg, jparams, _load(cfg, jparams)


def _tokens(cfg, seed, b=B, s=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _embeds(cfg, seed, b=B, s=S):
    """The frontend embeddings a batch of ``cfg`` carries, numpy, at the
    frontends' 0.02 scale."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.n_img_tokens:
        out["img_embeds"] = rng.standard_normal((b, cfg.n_img_tokens, cfg.d_model)) * 0.02
    if cfg.enc_dec:
        out["audio_embeds"] = rng.standard_normal((b, s, cfg.d_model)) * 0.02
    return {k: v.astype(np.float32) for k, v in out.items()}


def _batches(tok, embeds):
    return ({"tokens": torch.as_tensor(tok), **{k: torch.as_tensor(v) for k, v in embeds.items()}},
            {"tokens": jnp.asarray(tok), **{k: jnp.asarray(v) for k, v in embeds.items()}})


def _close(cfg, got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL.get(cfg.name, 1e-5))


def test_param_count(pair):
    cfg, jcfg, jparams, model = pair
    assert T.param_count(model) == J.param_count(jparams)
    assert set(model.state_dict()) == set(lm_params_from_numpy(cfg, _np(jparams), "cpu"))


@pytest.mark.parametrize("remat", [False, True])
def test_forward_matches_reference(pair, remat):
    cfg, jcfg, jparams, model = pair
    tb, jb = _batches(_tokens(cfg, 1), _embeds(cfg, 1))
    got, aux = T.forward(cfg, model, tb, remat=remat)
    want, jaux = J.forward(jcfg, jparams, jb, remat=remat)
    assert got.shape == (B, S, cfg.vocab)
    _close(cfg, got, want)
    assert set(aux) == set(jaux) == ({"moe_balance"} if cfg.moe is not None else set())
    for key in jaux:
        _close(cfg, aux[key], jaux[key])


def test_prefill_and_decode_match_reference(pair):
    cfg, jcfg, jparams, model = pair
    tok, embeds = _tokens(cfg, 2, s=S + 4), _embeds(cfg, 2)
    tb, jb = _batches(tok[:, :S], embeds)
    got, cache = make_prefill_step(cfg)(model, tb)
    want, jcache = J.prefill(jcfg, jparams, jb)
    _close(cfg, got, want)
    assert set(cache) == set(jcache)
    for key in jcache:
        assert set(cache[key]) == set(jcache[key])
        for name in jcache[key]:
            assert cache[key][name].shape == jcache[key][name].shape
            assert cache[key][name].dtype == getattr(torch, str(jcache[key][name].dtype))
            _close(cfg, cache[key][name], jcache[key][name])
    cache = T.pad_cache(cfg, cache, S + 6)
    jcache = J.pad_cache(jcfg, jcache, S + 6)
    for key in jcache:
        for name in jcache[key]:
            assert cache[key][name].shape == jcache[key][name].shape
    for i in range(4):
        pos = np.full((B,), S + i, np.int32)
        got, cache = T.decode_step(cfg, model, torch.as_tensor(tok[:, S + i]),
                                   torch.as_tensor(pos), cache)
        want, jcache = J.decode_step(jcfg, jparams, jnp.asarray(tok[:, S + i]),
                                     jnp.asarray(pos), jcache)
        _close(cfg, got, want)
    for key in jcache:
        for name in jcache[key]:
            _close(cfg, cache[key][name], jcache[key][name])


def test_init_cache_matches_reference(pair):
    cfg, jcfg, _, model = pair
    cache = model.init_cache(B, 9, enc_len=5)
    jcache = J.init_cache(jcfg, B, 9, enc_len=5)
    assert set(cache) == set(jcache)
    for key in jcache:
        for name, want in jcache[key].items():
            got = cache[key][name]
            assert got.shape == want.shape and got.dtype == getattr(torch, str(want.dtype))
            assert not got.any()


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_own_forward(arch):
    """``test_archs.test_decode_matches_forward`` on the port: decode from
    zero caches (the reference zeroes the xLSTMs' -1e30 stabilizer too) at
    that test's 2e-2; the attention, MoE and Mamba kinds also at 1e-4."""
    cfg = get_config(arch, reduced=True)
    model = T.LM(cfg, device="cpu", seed=0)
    s = 12
    tok = torch.as_tensor(_tokens(cfg, 3, s=s))
    with torch.no_grad():
        full, _ = model.forward({"tokens": tok})
    cache = model.init_cache(B, s + 2)
    errs = []
    for i in range(s):
        lg, cache = model.decode_step(tok[:, i], torch.full((B,), i), cache)
        errs.append(float((lg - full[:, i]).abs().max()))
    assert max(errs) < 2e-2, errs
    if arch != "xlstm_350m":
        assert max(errs) < 1e-4, errs


def test_whisper_prefill_decode_consistency():
    cfg = get_config("whisper_large_v3", reduced=True)
    model = T.LM(cfg, device="cpu", seed=0)
    s = 16
    tok = torch.as_tensor(_tokens(cfg, 4, s=s + 1))
    audio = frontends.fake_audio_embeds(cfg, B, s, device="cpu")
    with torch.no_grad():
        lg_full, _ = model.forward({"tokens": tok, "audio_embeds": audio})
    lg_pre, cache = model.prefill({"tokens": tok[:, :s], "audio_embeds": audio})
    assert float((lg_pre - lg_full[:, s - 1]).abs().max()) < 2e-4
    assert cache["b0"]["xk"].shape == (cfg.n_periods, B, s, cfg.n_kv_heads * cfg.hd)
    cache = model.pad_cache(cache, s + 4)
    assert cache["b0"]["xk"].shape[2] == s and cache["b0"]["k"].shape[2] == s + 4
    lg_dec, _ = model.decode_step(tok[:, s], torch.full((B,), s), cache)
    assert float((lg_dec - lg_full[:, s]).abs().max()) < 2e-4


def test_llava_image_tokens():
    cfg = get_config("llava_next_34b", reduced=True)
    model = T.LM(cfg, device="cpu", seed=0)
    img = frontends.fake_img_embeds(cfg, B, device="cpu")
    batch = {"tokens": torch.as_tensor(_tokens(cfg, 5, s=32)), "img_embeds": img}
    with torch.no_grad():
        l1, _ = model.forward(batch)
        l2, _ = model.forward(dict(batch, img_embeds=img + 1.0))
    lg_pre, _ = model.prefill(batch)
    assert float((lg_pre - l1[:, -1]).abs().max()) < 2e-4
    assert float((l1 - l2).abs().max()) > 1e-4


def _args(**kw):
    base = dict(reduced=True, batch=2, prompt_len=12, gen=5, seed=0, model_parallel=1,
                device="cpu")
    return argparse.Namespace(**{**base, **kw})


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "jamba_v0_1_52b", "whisper_large_v3",
                                  "llava_next_34b"])
def test_serve_matches_reference_loop(arch):
    args = _args(arch=arch)
    cfg, jcfg = get_config(arch, reduced=True), jget_config(arch, reduced=True)
    jparams = J.init_params(jcfg, KEY)
    prompts = _tokens(cfg, 7, b=args.batch, s=args.prompt_len)
    embeds = _embeds(cfg, 7, b=args.batch, s=args.prompt_len)
    # The reference's greedy loop (launch/serve.run without its mesh).
    jlogits, jcache = J.prefill(jcfg, jparams, _batches(prompts, embeds)[1])
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

    got = {}
    out = serve.run(args, model=_load(cfg, jparams), prompts=prompts, embeds=embeds, feed=feed,
                    record=lambda step, lg: got.__setitem__(step, lg.clone()))
    assert sorted(got) == list(range(args.gen))
    for step in range(args.gen):
        _close(cfg, got[step], want[step])
    np.testing.assert_array_equal(out["tokens"], feed)  # greedy == the reference's tokens


@pytest.mark.parametrize("arch", all_archs())
def test_every_config_serves_on_the_cpu(arch):
    out = serve.main(["--device", "cpu", "--arch", arch, "--batch", "2", "--prompt-len", "16",
                      "--gen", "3"])
    cfg = get_config(arch, reduced=True)
    assert out["tokens"].shape == (2, 3)
    assert ((0 <= out["tokens"]) & (out["tokens"] < cfg.vocab)).all()


@pytest.mark.parametrize("arch", ["jamba_v0_1_52b", "xlstm_350m"])
def test_bf16_weights_carry_across(arch):
    """The converter takes each leaf's dtype from the LM's parameter: the
    reference's float32 leaves stay float32 in a bf16 model, the rest carry
    across exactly."""
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="bfloat16")
    jparams = J.init_params(dataclasses.replace(jget_config(arch, reduced=True),
                                                dtype="bfloat16"), KEY)
    state = lm_params_from_numpy(cfg, _np(jparams), "cpu")
    f32 = {"A_log", "D", "dt_bias", "router", "wi", "wf", "_scale"}
    for name, t in state.items():
        want = torch.float32 if name.rsplit(".", 1)[-1] in f32 else torch.bfloat16
        assert t.dtype == want, name
    flat = jax.tree_util.tree_flatten_with_path(_np(jparams))[0]
    for path, x in flat:
        keys = [getattr(k, "key", None) for k in path]
        if keys[0] != "blocks":
            continue
        i = int(keys[1][1:])
        name = f"blocks.{i}.{keys[2]}.{keys[3]}"  # period 0 of block b{i}
        np.testing.assert_array_equal(state[name].float().numpy(), x[0], err_msg=name)
    model = T.LM(cfg, device="cpu")
    model.load_state_dict(state)
    lg, cache = model.prefill({"tokens": torch.as_tensor(_tokens(cfg, 6, s=16))})
    assert lg.dtype == torch.bfloat16 and bool(torch.isfinite(lg).all())
    cache = model.pad_cache(cache, 17)
    lg, _ = model.decode_step(torch.as_tensor(_tokens(cfg, 6, s=1)[:, 0]), torch.full((B,), 16),
                              cache)
    assert bool(torch.isfinite(lg).all())


def test_frontends():
    cfg = get_config("llava_next_34b", reduced=True)
    img = frontends.fake_img_embeds(cfg, 3, device="cpu")
    assert img.shape == (3, cfg.n_img_tokens, cfg.d_model) and img.dtype == torch.float32
    torch.testing.assert_close(img, frontends.fake_img_embeds(cfg, 3, device="cpu"), rtol=0,
                               atol=0)
    wcfg = get_config("whisper_large_v3")  # bf16, d = 1280
    audio = frontends.fake_audio_embeds(wcfg, 2, 300, device="cpu")
    assert audio.shape == (2, 300, wcfg.d_model) and audio.dtype == torch.bfloat16
    assert abs(float(audio.float().std()) / 0.02 - 1.0) < 0.02
    g = torch.Generator().manual_seed(5)
    other = frontends.fake_audio_embeds(wcfg, 2, 300, generator=g)
    assert not torch.equal(other, audio)
    assert torch.equal(other, frontends.fake_audio_embeds(
        wcfg, 2, 300, generator=torch.Generator().manual_seed(5)))
