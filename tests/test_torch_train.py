"""The port's LM training path against the JAX package's, on the same numpy
inputs.

- (a) ``ref.flash_attention_bwd`` (the plain version of the CUDA backward)
  against ``jax.grad`` of the reference's ``models.attention.flash_attention``
  (causal and bidirectional, GQA and MQA, ragged lengths, ``q_offset``) in
  float32 at 1e-5 (relative to the gradient's largest entry: the reference
  computes in float32 whatever the input dtype).  In float64 against
  ``jax.grad`` of the same attention written quadratically in float64
  (the reference's flash_attention casts to float32, so a float64 hold at
  1e-12 needs a float64 formulation of its math) and against
  ``torch.autograd`` of the port's own blocked forward, both at 1e-12.  The
  forward's ``lse=`` output against the log-sum-exp of the scores, and
  ``autograd.FlashAttention`` on CPU tensors: the plain pair, reached by
  ``ops.flash_attention_fwd`` when grad is on.  The card's rule
  (``tools/attn_checks.hold``) with the kernels stood in by the plain
  versions: they pass, and a wrong ``lse`` or gradient is refused.
- (b) ``data.SyntheticTokens`` batches bitwise equal to the reference's.
- (c) ``train.steps.make_train_step`` for three steps against the reference's
  ``make_train_step`` jitted without a mesh (its mesh path fails on this JAX,
  ROADMAP C-3) from the same state (``convert.train_state_from_numpy``),
  on reduced stablelm-3b and qwen2.5-14b (GQA) in float32, with ``remat`` on
  and off and both optimizers: loss, grad norm and lr at each step, and the
  parameters after the third (8-bit moments: the first two steps' metrics
  and the parameters after the first; see ``HELD_STEPS``).
- (d) the launcher: ``launch.train.run(--device cpu)`` lowers the loss
  (``--model-parallel`` and ``--fsdp`` run on a mesh in
  ``test_torch_distributed_ranks.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import SyntheticTokens as JSyntheticTokens  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy, train_state_from_numpy  # noqa: E402
from repro_torch.data import SyntheticTokens  # noqa: E402
from repro_torch.kernels import autograd, cuda_impl, ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.tools import attn_checks  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

# (b, sq, sk, H, KV, hd, causal, q_offset, q_chunk, kv_chunk)
BWD_CASES = [
    (2, 64, 64, 4, 2, 16, True, 0, 16, 16),     # GQA, causal, several blocks
    (1, 64, 64, 4, 4, 16, False, 0, 32, 16),    # bidirectional
    (2, 37, 37, 4, 2, 16, True, 0, 16, 16),     # ragged
    (2, 37, 45, 4, 2, 16, True, 8, 16, 32),     # ragged, q_offset
    (1, 13, 45, 4, 1, 8, True, 32, 8, 16),      # MQA, a continuation chunk
    (1, 37, 45, 4, 4, 16, False, 0, 16, 16),    # bidirectional, ragged keys
]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _inputs(seed, b, sq, sk, H, KV, hd, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(dtype)
                 for shape in ((b, sq, H, hd), (b, sk, KV, hd), (b, sk, KV, hd), (b, sq, H, hd)))


def _held(got, want, tol):
    """Each gradient within ``tol`` times its largest entry (at least 1)."""
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape
        err = np.abs(g - w).max()
        assert err <= tol * max(1.0, np.abs(w).max()), (err, np.abs(w).max())


def _torch_bwd(q, k, v, do, causal, q_offset, qc, kc):
    tq, tk, tv, tdo = map(torch.as_tensor, (q, k, v, do))
    o, lse = tref.flash_attention_fwd(tq, tk, tv, causal=causal, q_offset=q_offset, q_chunk=qc,
                                      kv_chunk=kc, lse=True)
    return tref.flash_attention_bwd(tq, tk, tv, o, lse, tdo, causal=causal, q_offset=q_offset,
                                    q_chunk=qc, kv_chunk=kc)


def _jax_quadratic(q, k, v, causal, q_offset):
    """The reference's attention math, unblocked and in the inputs' dtype:
    scores scaled by 1/sqrt(hd), keys after each query's position masked
    at -1e30, softmax, GQA head h on KV head h // G."""
    b, sq, H, hd = q.shape
    sk, KV = k.shape[1], k.shape[2]
    qr = q.reshape(b, sq, KV, H // KV, hd) / jnp.sqrt(jnp.asarray(hd, q.dtype))
    s = jnp.einsum("bqKGh,bkKh->bKGqk", qr, k)
    if causal:
        mask = jnp.arange(sk)[None, :] > (q_offset + jnp.arange(sq))[:, None]
        s = jnp.where(mask, jattn.NEG_INF, s)
    o = jnp.einsum("bKGqk,bkKh->bKGqh", jax.nn.softmax(s, axis=-1), v)
    return o.transpose(0, 3, 1, 2, 4).reshape(b, sq, H, hd)


def _jax_grads(fn, q, k, v, do):
    return jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) * do), argnums=(0, 1, 2))(q, k, v)


class TestAttentionBackward:
    @pytest.mark.parametrize("b,sq,sk,H,KV,hd,causal,q_offset,qc,kc", BWD_CASES)
    def test_float32_against_jax_grad_of_reference(self, b, sq, sk, H, KV, hd, causal,
                                                   q_offset, qc, kc):
        q, k, v, do = _inputs(sq * sk + H, b, sq, sk, H, KV, hd)
        got = _torch_bwd(q, k, v, do, causal, q_offset, qc, kc)
        want = _jax_grads(lambda q, k, v: jattn.flash_attention(
            q, k, v, causal=causal, q_offset=q_offset, q_chunk=qc, kv_chunk=kc),
            *map(jnp.asarray, (q, k, v, do)))
        assert all(g.dtype == torch.float32 for g in got)
        _held(got, want, 1e-5)

    @pytest.mark.parametrize("b,sq,sk,H,KV,hd,causal,q_offset,qc,kc", BWD_CASES)
    def test_float64_against_jax_and_torch_autograd(self, b, sq, sk, H, KV, hd, causal,
                                                    q_offset, qc, kc):
        q, k, v, do = _inputs(sq * sk + H + 1, b, sq, sk, H, KV, hd, np.float64)
        got = _torch_bwd(q, k, v, do, causal, q_offset, qc, kc)
        assert all(g.dtype == torch.float64 for g in got)
        with jax.enable_x64(True):
            want = _jax_grads(lambda q, k, v: _jax_quadratic(q, k, v, causal, q_offset),
                              *map(jnp.asarray, (q, k, v, do)))
            want = [np.asarray(w) for w in want]
        _held(got, want, 1e-12)
        tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
        out = tref.flash_attention_fwd(tq, tk, tv, causal=causal, q_offset=q_offset,
                                       q_chunk=qc, kv_chunk=kc)
        _held(got, torch.autograd.grad(out, (tq, tk, tv), torch.as_tensor(do)), 1e-12)

    def test_lse_is_the_rows_log_sum_exp(self):
        q, k, v, _ = _inputs(5, 2, 37, 45, 4, 2, 16, np.float64)
        tq, tk, tv = map(torch.as_tensor, (q, k, v))
        out, lse = tref.flash_attention_fwd(tq, tk, tv, q_offset=8, q_chunk=16, kv_chunk=16,
                                            lse=True)
        assert torch.equal(out, tref.flash_attention_fwd(tq, tk, tv, q_offset=8, q_chunk=16,
                                                         kv_chunk=16))
        s = torch.einsum("bqKGh,bkKh->bKGqk", tq.reshape(2, 37, 2, 2, 16), tk) / 4.0
        s = torch.where(torch.arange(45)[None, :] > 8 + torch.arange(37)[:, None], -np.inf, s)
        torch.testing.assert_close(lse, torch.logsumexp(s, -1).reshape(2, 4, 37), rtol=1e-12,
                                   atol=1e-12)
        _, lse32 = tref.flash_attention_fwd(tq.float(), tk.float(), tv.float(), lse=True)
        assert lse32.dtype == torch.float32 and lse32.shape == (2, 4, 37)

    def test_function_on_cpu_is_the_plain_pair(self):
        q, k, v, do = _inputs(7, 2, 37, 45, 4, 2, 16)
        tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
        out = ops.flash_attention_fwd(tq, tk, tv, q_offset=8, q_chunk=16, kv_chunk=32)
        assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
        got = torch.autograd.grad(out, (tq, tk, tv), torch.as_tensor(do))
        want = _torch_bwd(q, k, v, do, True, 8, 16, 32)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        with torch.no_grad():
            assert ops.flash_attention_fwd(tq, tk, tv).grad_fn is None
        assert torch.equal(autograd.flash_attention(tq, tk, tv, q_offset=8, q_chunk=16,
                                                    kv_chunk=32), out)


    def test_cuda_backward_refuses_before_launch(self):
        """The CUDA wrapper raises on what its C entry would refuse, before
        any launch: a head dim above 128, a cotangent or an lse of the
        wrong shape, and (last) a CPU tensor."""
        before = dict(cuda_impl.launches)
        q = torch.zeros(1, 8, 4, 136)
        lse = torch.zeros(1, 4, 8)
        with pytest.raises(ValueError, match="head dim"):
            cuda_impl.flash_attention_bwd(q, q, q, q, lse, q)
        q = q[..., :16].contiguous()
        with pytest.raises(ValueError, match="shapes"):
            cuda_impl.flash_attention_bwd(q, q, q, q, lse, q[:, :4])
        with pytest.raises(ValueError, match="lse"):
            cuda_impl.flash_attention_bwd(q, q, q, q, lse[..., :4], q)
        with pytest.raises(ValueError, match="CUDA tensors"):
            cuda_impl.flash_attention_bwd(q, q, q, q, lse, q)
        assert cuda_impl.launches == before


class TestAttnChecksRule:
    """``tools/attn_checks.hold``, the card's rule, on the CPU: the kernels
    stood in by the plain versions pass it, and a forward whose ``lse`` is
    off by one part in 1e4, or a backward off in one gradient, is refused."""

    @staticmethod
    def _stand_ins(monkeypatch, lse_scale=1.0, dv_scale=1.0):
        def fwd(q, k, v, *, causal=True, q_offset=0, lse=False):
            out = tref.flash_attention_fwd(q, k, v, causal=causal, q_offset=q_offset, lse=lse,
                                           q_chunk=16, kv_chunk=32)
            return (out[0], out[1].contiguous() * lse_scale) if lse else out

        def bwd(q, k, v, o, lse, do, *, causal=True, q_offset=0):
            dq, dk, dv = tref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                                  q_offset=q_offset, q_chunk=16, kv_chunk=32)
            return dq, dk, dv * dv_scale

        monkeypatch.setattr(cuda_impl, "flash_attention_fwd", fwd)
        monkeypatch.setattr(cuda_impl, "flash_attention_bwd", bwd)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_plain_versions_pass(self, monkeypatch, dtype):
        self._stand_ins(monkeypatch)
        case, dt = attn_checks.CASES[0], getattr(torch, dtype)
        res = attn_checks.hold("stand-in", case, dt, *attn_checks.inputs(1, case, dt, "cpu"))
        assert res["lse_rel_err"] <= attn_checks.LSE_TOL
        assert max(res["rel_err"]) <= attn_checks.F32_TOL or dt == torch.bfloat16

    @pytest.mark.parametrize("scales,match", [((1.0 + 1e-4, 1.0), "lse"),
                                              ((1.0, 1.01), "dv")])
    def test_a_wrong_lse_or_gradient_is_refused(self, monkeypatch, scales, match):
        self._stand_ins(monkeypatch, *scales)
        case = attn_checks.CASES[0]
        with pytest.raises(AssertionError, match=match):
            attn_checks.hold("stand-in", case, torch.float32,
                             *attn_checks.inputs(1, case, torch.float32, "cpu"))


class TestData:
    def test_batches_bitwise_equal_to_reference(self):
        for kw in (dict(vocab=256, seq_len=32, global_batch=8, seed=3),
                   dict(vocab=50304, seq_len=64, global_batch=4)):
            ds, jds = SyntheticTokens(**kw), JSyntheticTokens(**kw)
            for step in (0, 5, 17):
                got, want = ds.batch(step), jds.batch(step)
                for key in ("tokens", "labels"):
                    assert got[key].dtype == want[key].dtype
                    np.testing.assert_array_equal(got[key], want[key])
            np.testing.assert_array_equal(ds.batch(2, lo=1, hi=3)["tokens"],
                                          jds.batch(2)["tokens"][1:3])

    def test_labels_are_shifted_tokens(self):
        b = SyntheticTokens(vocab=256, seq_len=16, global_batch=2).batch(0)
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


B, S, STEPS = 2, 24, 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


@pytest.fixture(scope="module", params=["stablelm-3b", "qwen2.5-14b"])
def arch_case(request):
    """(arch, the reference's initial train state as numpy, the batches)."""
    arch = request.param
    jcfg = jget_config(arch, reduced=True)
    states = {opt: _np(jsteps.init_train_state(jcfg, jax.random.PRNGKey(0), optimizer=opt))
              for opt in ("adamw", "adamw8bit")}
    ds = SyntheticTokens(vocab=jcfg.vocab, seq_len=S, global_batch=B)
    return arch, states, [ds.batch(i) for i in range(STEPS)]


# The three-step comparison, float32.  Loss, cross entropy and gradient
# norm agree to float32 rounding through two layers (1e-5 relative), lr to
# 1e-7.  A parameter moves by up to about lr (1e-3) a step however small its
# gradient, and an entry whose gradient is near eps takes g / (|g| + eps) of
# it, a share that float32 rounding of g changes: so 99.9 % of the entries
# are held within 1e-6 and every entry within 1e-4, a tenth of a step.
#
# The 8-bit moments make the update discontinuous: a v entry that
# quantizes to 0 leaves the next step's v to one gradient alone, and an
# entry whose gradient is near 0 then moves by m / (sqrt(v) + eps), up to
# O(1), in whichever framework's rounding lands it there.  Its moments
# start at 0, so the first step is AdamW's and is held as above, and the
# second step's metrics (from the first step's parameters) too; past that
# the two runs part by construction, and the update itself is held to the
# reference's on identical inputs in test_torch_optim.py.
HELD_STEPS = {"adamw": STEPS, "adamw8bit": 2}  # steps whose metrics are held
PARAMS_AFTER = {"adamw": STEPS, "adamw8bit": 1}  # the step after which parameters are


def _hold_params(state, jparams, cfg):
    want = lm_params_from_numpy(cfg, _np(jparams), "cpu")
    got = dict(state["params"].named_parameters())
    assert set(got) == set(want)
    diff = np.concatenate([np.abs(p.detach().numpy() - want[n].numpy()).ravel()
                           for n, p in got.items()])
    assert diff.max() <= 1e-4, diff.max()
    assert np.quantile(diff, 0.999) <= 1e-6, np.quantile(diff, 0.999)


@pytest.mark.parametrize("optimizer", ["adamw", "adamw8bit"])
@pytest.mark.parametrize("remat", [False, True])
def test_train_step_matches_reference(arch_case, remat, optimizer):
    arch, states, batches = arch_case
    cfg, jcfg = get_config(arch, reduced=True), jget_config(arch, reduced=True)
    jstep = jax.jit(jsteps.make_train_step(jcfg, JAdamWConfig(**OPT), remat=remat,
                                           optimizer=optimizer))
    jstate = jax.tree_util.tree_map(jnp.asarray, states[optimizer])
    state = train_state_from_numpy(cfg, states[optimizer], "cpu")
    step = make_train_step(cfg, AdamWConfig(**OPT), remat=remat, optimizer=optimizer)
    held = HELD_STEPS[optimizer]
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, {k: torch.as_tensor(v) for k, v in batch.items()})
        assert all(np.isfinite(float(v)) for v in m.values())
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-7)
        if i < held:
            for key in ("loss", "ce_loss", "grad_norm"):
                np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5,
                                           err_msg=f"step {i}: {key}")
        if i + 1 == PARAMS_AFTER[optimizer]:
            _hold_params(state, jstate["params"], cfg)
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == STEPS


class TestLauncher:
    def _args(self, **kw):
        base = ["--arch", "stablelm-3b", "--batch", "4", "--seq", "32", "--device", "cpu",
                "--log-every", "100"]
        return tlaunch.parser().parse_args(base + [str(x) for kv in kw.items() for x in kv])

    def test_loss_falls(self):
        out = tlaunch.run(self._args(**{"--steps": 12}))
        assert out["start"] == 0 and len(out["losses"]) == 12
        assert out["losses"][-1] < out["losses"][0]
        assert all(set(ms) == {"forward", "backward", "optimizer", "step"}
                   for ms in out["step_ms"])

    def test_cuda_without_a_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlaunch.run(tlaunch.parser().parse_args(["--device", "cuda"]))
