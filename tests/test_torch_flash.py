"""The port's attention layer against the JAX package's, on the same numpy
inputs.

- (a) ``ref.flash_attention_fwd`` (the plain version of the CUDA kernel)
  against the Pallas ``flash_attention_fwd`` in interpret mode and the
  quadratic oracle ``flash_attn.ref``, over ``tests/test_flash_kernel.py``'s
  five ``CASES`` and the new model kinds' head dims (whisper's 64,
  kimi-k2's 112; ``HEAD_CASES``) in float32 (2e-5), and its bf16 case (3e-2,
  bf16 out); the port's oracle ``ref.flash_attention_ref`` against JAX's.
- (b) ``models.attention.flash_attention`` against JAX's
  ``models.attention.flash_attention`` with ragged lengths, ``q_offset > 0``,
  bidirectional attention, MQA and whisper's cross attention (hd 64,
  bidirectional, sq != sk) (2e-5), and the pair schedule
  ``_block_pairs`` against the reference's.
- (c) ``decode_attention`` against JAX's at a padded cache (1e-6).
- (d) ``rmsnorm``, ``layernorm`` and ``apply_rope`` against JAX's (1e-6;
  for ``layernorm`` of the output's scale).
- (e) the dispatch: a CPU tensor takes the plain version and launches
  nothing; the CUDA wrapper refuses a CPU tensor.

The CUDA kernel is held to the plain version on the card in
``test_torch_kernels_card.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attn as jflash  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro_torch.kernels import cuda_impl, ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from test_flash_kernel import CASES  # noqa: E402

# The head dims of the configs beyond the dense ones: whisper-large-v3's 64
# (MHA, bidirectional in its encoder) and kimi-k2's 112 (GQA 8:1, causal).
HEAD_CASES = [(2, 32, 4, 4, 64, False, 16, 16), (1, 64, 8, 1, 112, True, 16, 32)]
TOL32 = 2e-5  # the reference's own kernel-vs-oracle tolerance (float32)
TOL16 = 3e-2  # and its bf16 one


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _qkv(seed, b, sq, sk, H, KV, hd, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(dtype)
                 for shape in ((b, sq, H, hd), (b, sk, KV, hd), (b, sk, KV, hd)))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


class TestFlashKernelPlain:
    @pytest.mark.parametrize("b,s,H,KV,hd,causal,qc,kc", CASES + HEAD_CASES)
    def test_matches_pallas_interpret_and_oracle(self, b, s, H, KV, hd, causal, qc, kc):
        q, k, v = _qkv(b * s + H, b, s, s, H, KV, hd)
        got = tref.flash_attention_fwd(*map(torch.as_tensor, (q, k, v)), causal=causal,
                                       q_chunk=qc, kv_chunk=kc)
        assert got.dtype == torch.float32 and got.shape == (b, s, H, hd)
        pallas = jflash.flash_attention_fwd(*map(jnp.asarray, (q, k, v)), causal=causal,
                                            q_chunk=qc, kv_chunk=kc, interpret=True)
        oracle = jflash.ref(*map(jnp.asarray, (q, k, v)), causal=causal)
        _close(got, pallas, TOL32)
        _close(got, oracle, TOL32)
        port_oracle = tref.flash_attention_ref(*map(torch.as_tensor, (q, k, v)), causal=causal)
        _close(port_oracle, oracle, TOL32)

    def test_bf16_inputs_f32_accum(self):
        q, k, v = _qkv(0, 1, 64, 64, 4, 2, 16)
        tq, tk, tv = (torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v))
        jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
        got = tref.flash_attention_fwd(tq, tk, tv, q_chunk=32, kv_chunk=32)
        assert got.dtype == torch.bfloat16
        pallas = jflash.flash_attention_fwd(jq, jk, jv, q_chunk=32, kv_chunk=32, interpret=True)
        _close(got.float(), pallas, TOL16)
        _close(got.float(), jflash.ref(jq, jk, jv), TOL16)


# b, sq, sk, H, KV, hd, causal, q_offset, q_chunk, kv_chunk
MODEL_CASES = [
    (2, 37, 37, 4, 2, 16, True, 0, 16, 16),     # ragged, both lengths
    (2, 37, 45, 4, 2, 16, True, 8, 16, 16),     # chunked-prefill continuation
    (1, 13, 45, 4, 2, 16, True, 32, 16, 32),    # a short continuation chunk
    (1, 37, 45, 4, 4, 16, False, 0, 16, 32),    # bidirectional, ragged
    (1, 45, 45, 4, 1, 16, True, 0, 32, 16),     # MQA
    (2, 64, 64, 4, 2, 16, True, 0, 16, 16),     # the kernel's function exactly
    (1, 20, 30, 4, 4, 64, False, 0, 16, 16),    # cross attention (whisper's hd)
]


class TestModelAttention:
    @pytest.mark.parametrize("b,sq,sk,H,KV,hd,causal,q_offset,qc,kc", MODEL_CASES)
    def test_flash_attention_matches_reference(self, b, sq, sk, H, KV, hd, causal, q_offset,
                                               qc, kc):
        q, k, v = _qkv(sq * sk + q_offset, b, sq, sk, H, KV, hd)
        kw = dict(causal=causal, q_offset=q_offset, q_chunk=qc, kv_chunk=kc)
        got = tattn.flash_attention(*map(torch.as_tensor, (q, k, v)), **kw)
        want = jattn.flash_attention(*map(jnp.asarray, (q, k, v)), **kw)
        assert got.shape == (b, sq, H, hd)
        _close(got, want, TOL32)

    @pytest.mark.parametrize("nq,nk,qc,kc,sk0,causal,q_offset", [
        (4, 4, 16, 16, 64, True, 0), (3, 3, 16, 16, 45, True, 8), (3, 2, 16, 32, 45, False, 0),
        (1, 2, 16, 32, 45, True, 32), (2, 4, 32, 16, 64, True, 0)])
    def test_block_pairs(self, nq, nk, qc, kc, sk0, causal, q_offset):
        args = (nq, nk, qc, kc, sk0, causal, q_offset)
        assert tattn._block_pairs(*args) == jattn._block_pairs(*args)
        if q_offset == 0 and sk0 == nk * kc:
            assert tattn._block_pairs(*args) == jflash._pairs(nq, nk, qc, kc, causal)

    @pytest.mark.parametrize("H,KV", [(4, 2), (4, 4), (4, 1)])
    def test_decode_attention_at_a_padded_cache(self, H, KV):
        rng = np.random.default_rng(H * 10 + KV)
        b, S, hd = 3, 20, 16
        q = rng.standard_normal((b, H, hd)).astype(np.float32)
        kc = rng.standard_normal((b, S, KV, hd)).astype(np.float32)
        vc = rng.standard_normal((b, S, KV, hd)).astype(np.float32)
        pos = np.array([0, 7, 15], np.int32)  # rows past pos are padding
        got = tattn.decode_attention(*map(torch.as_tensor, (q, kc, vc, pos)))
        want = jattn.decode_attention(*map(jnp.asarray, (q, kc, vc, pos)))
        _close(got, want, 1e-6)


class TestCommon:
    def test_rmsnorm(self):
        rng = np.random.default_rng(0)
        x, s = rng.standard_normal((2, 5, 64)).astype(np.float32), rng.uniform(0.5, 2, 64)
        s = s.astype(np.float32)
        _close(tcommon.rmsnorm(torch.as_tensor(x), torch.as_tensor(s)),
               jcommon.rmsnorm(jnp.asarray(x), jnp.asarray(s)), 1e-6)

    def test_layernorm(self):
        rng = np.random.default_rng(1)
        x = (3.0 + rng.standard_normal((2, 5, 48))).astype(np.float32)
        s, bias = (rng.standard_normal(48).astype(np.float32) for _ in range(2))
        got = tcommon.layernorm(*map(torch.as_tensor, (x, s, bias))).numpy()
        want = np.asarray(jcommon.layernorm(*map(jnp.asarray, (x, s, bias))))
        # 1e-6 of the output's scale: the inputs sit at 3 +- 1, so the two
        # float32 means round apart by an ulp of 3 (2.4e-7), which the
        # normalization multiplies by scale / std (both a few units).
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())

    @pytest.mark.parametrize("theta", [1e4, 1e6])
    def test_apply_rope(self, theta):
        rng = np.random.default_rng(2)
        x = rng.standard_normal((2, 37, 4, 16)).astype(np.float32)
        positions = np.broadcast_to(np.arange(37, dtype=np.int32), (2, 37)).copy()
        _close(tcommon.apply_rope(torch.as_tensor(x), torch.as_tensor(positions), theta),
               jcommon.apply_rope(jnp.asarray(x), jnp.asarray(positions), theta), 1e-6)
        np.testing.assert_array_equal(tcommon.rope_freqs(16, theta),
                                      jcommon.rope_freqs(16, theta))

    def test_norms_keep_the_input_dtype(self):
        x = torch.randn(2, 3, 8, dtype=torch.bfloat16)
        one = torch.ones(8)
        assert tcommon.rmsnorm(x, one).dtype == torch.bfloat16
        assert tcommon.layernorm(x, one, torch.zeros(8)).dtype == torch.bfloat16
        pos = torch.arange(3).expand(2, 3)
        assert tcommon.apply_rope(x.reshape(2, 3, 2, 4), pos, 1e4).dtype == torch.bfloat16


class TestDispatch:
    def test_cpu_takes_the_plain_version(self):
        q, k, v = map(torch.as_tensor, _qkv(3, 1, 37, 37, 4, 2, 16))
        before = ops.launches["flash_attention_fwd"]
        got = ops.flash_attention_fwd(q, k, v, q_chunk=16, kv_chunk=16)
        assert ops.launches["flash_attention_fwd"] == before
        assert torch.equal(got, tref.flash_attention_fwd(q, k, v, q_chunk=16, kv_chunk=16))

    def test_kernel_refuses_cpu_tensors(self):
        q, k, v = map(torch.as_tensor, _qkv(3, 1, 8, 8, 2, 1, 8))
        with pytest.raises(ValueError, match="CUDA tensors"):
            cuda_impl.flash_attention_fwd(q, k, v)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            cuda_impl.flash_attention_fwd(q.double(), k.double(), v.double())
