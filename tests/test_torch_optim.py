"""The port's optimizers (``repro_torch.optim``) against the JAX package's
on the same numpy trees.

- ``adamw_update``: five steps with the same gradients fed to both, the
  parameters (float32 and bfloat16) and moments within 1e-6 relative (the
  same expressions; XLA's and ATen's float32 ``pow`` and ``cos`` may differ
  by an ulp in the bias corrections and the schedule), lr likewise.
- ``qadamw_update``: the same, the int8 moments bitwise equal (they do not
  see the bias corrections) and the scales within 1e-6.
- ``quantize_blockwise``: bitwise the reference's blocks and scales, and the
  round trip within 1 % of the largest entry; ``cosine_lr`` and
  ``clip_by_global_norm`` against the reference; AdamW and 8-bit AdamW
  converge on the reference's quadratic.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import quantized as jquant  # noqa: E402
from repro_torch.optim import adamw, quantized  # noqa: E402

CFG = dict(lr=0.05, warmup_steps=2, total_steps=20, weight_decay=0.1)


def _tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((4, 300)).astype(dtype),
            "b": rng.standard_normal((7,)).astype(dtype),
            "e": rng.standard_normal((3, 5, 260)).astype(dtype)}


def _close(got, want, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                                          np.float32),
                               np.asarray(want, np.float32), rtol=rtol, atol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("eight_bit", [False, True])
def test_update_matches_reference(dtype, eight_bit):
    jcfg, cfg = jadamw.AdamWConfig(**CFG), adamw.AdamWConfig(**CFG)
    jinit, jupdate = ((jquant.qadamw_init, jquant.qadamw_update) if eight_bit
                      else (jadamw.adamw_init, jadamw.adamw_update))
    init, update = ((quantized.qadamw_init, quantized.qadamw_update) if eight_bit
                    else (adamw.adamw_init, adamw.adamw_update))
    jparams = {k: jnp.asarray(v).astype(dtype) for k, v in _tree(0).items()}
    params = {k: torch.as_tensor(v).to(getattr(torch, dtype)) for k, v in _tree(0).items()}
    jstate, state = jinit(jparams), init(params)
    for step in range(5):
        grads = _tree(step + 1)
        jparams, jstate, jextra = jupdate(jcfg, jparams, {k: jnp.asarray(v).astype(dtype)
                                                          for k, v in grads.items()}, jstate)
        out, state, extra = update(cfg, params, {k: torch.as_tensor(v).to(getattr(torch, dtype))
                                                 for k, v in grads.items()}, state)
        assert out is params  # in place
        _close(extra["lr"], jextra["lr"])
        for k in params:
            assert params[k].dtype == getattr(torch, dtype)
            _close(params[k], np.asarray(jparams[k], np.float32),
                   1e-6 if dtype == "float32" else 2 ** -8)
            for mom in ("m", "v"):
                if eight_bit:
                    np.testing.assert_array_equal(state[mom][k]["q"].numpy(),
                                                  np.asarray(jstate[mom][k]["q"]))
                    _close(state[mom][k]["s"], jstate[mom][k]["s"])
                else:
                    _close(state[mom][k], jstate[mom][k])
    assert int(state["step"]) == int(jstate["step"]) == 5


def test_quantize_blockwise_round_trip():
    x = np.random.default_rng(0).standard_normal((3, 1000)).astype(np.float32)
    q, s = quantized.quantize_blockwise(torch.as_tensor(x))
    jq, js = jquant.quantize_blockwise(jnp.asarray(x))
    assert q.dtype == torch.int8 and q.shape == (3, 1024) and s.shape == (3, 4)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    y = quantized.dequantize_blockwise(q, s, x.shape)
    assert y.shape == x.shape
    np.testing.assert_array_equal(y.numpy(), np.asarray(jquant.dequantize_blockwise(jq, js,
                                                                                   x.shape)))
    assert float((y - torch.as_tensor(x)).abs().max()) < np.abs(x).max() / 100


def test_schedule_and_clipping_match_reference():
    jcfg, cfg = jadamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100), \
        adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
    for step in (0, 1, 9, 10, 11, 55, 99, 100, 150):
        _close(adamw.cosine_lr(cfg, torch.tensor(step, dtype=torch.int32)),
               jadamw.cosine_lr(jcfg, jnp.asarray(step, jnp.int32)))
    assert float(adamw.cosine_lr(cfg, torch.tensor(100))) < 1e-6
    grads = _tree(3)
    for max_norm in (1.0, 1e3):
        got, gn = adamw.clip_by_global_norm({k: torch.as_tensor(v) for k, v in grads.items()},
                                            max_norm)
        want, jgn = jadamw.clip_by_global_norm({k: jnp.asarray(v) for k, v in grads.items()},
                                               max_norm)
        _close(gn, jgn)
        for k in grads:
            _close(got[k], want[k])


@pytest.mark.parametrize("eight_bit", [False, True])
def test_converges_on_quadratic(eight_bit):
    """The reference's optimizer test: minimise |w - 3|^2 + |b + 1|^2."""
    cfg = adamw.AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=0, total_steps=10_000)
    init, update = ((quantized.qadamw_init, quantized.qadamw_update) if eight_bit
                    else (adamw.adamw_init, adamw.adamw_update))
    params = {"w": torch.zeros(4, 300, requires_grad=True), "b": torch.zeros(7, requires_grad=True)}
    state = init(params)

    def loss():
        return ((params["w"] - 3.0) ** 2).sum() + ((params["b"] + 1.0) ** 2).sum()

    for _ in range(300 if not eight_bit else 150):
        grads = dict(zip(params, torch.autograd.grad(loss(), list(params.values()))))
        update(cfg, params, grads, state)
    assert float(loss()) < 0.05
