"""The port's ops (``repro_torch.kernels``) against the JAX package's.

Every plain op in ``repro_torch.kernels.ref`` is held against the op of the
same name in ``repro.kernels.ref`` on the same numpy inputs: float32 at
rtol = atol = 1e-6 (rounding only -- XLA:CPU fuses and contracts differently)
and float64 at 1e-12.  One small case of each kernel op also goes through the
Pallas kernel in interpret mode.  The CUDA kernels themselves are compared
with their plain versions on the card in ``test_torch_kernels_card.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import pallas_impl  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import cuda_impl, ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = {np.float32: 1e-6, np.float64: 1e-12}
SHAPES = [(5, 3), (13, 300), (1, 1)]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _close(t, j, dtype):
    t = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape and t.dtype == j.dtype
    np.testing.assert_allclose(t, j, rtol=TOL[dtype], atol=TOL[dtype])


def _jax(fn, dtype):
    """Run ``fn`` with JAX in the dtype's precision; numpy results out."""
    with jax.enable_x64(dtype == np.float64):
        return jax.tree_util.tree_map(np.asarray, fn())


def _tol(kind, b, f, rng, dtype):
    if kind == "scalar":
        return 1e-4, 1e-3
    shape = (b,) if kind == "row" else (b, f)
    return (rng.uniform(1e-6, 1e-3, shape).astype(dtype),
            rng.uniform(1e-5, 1e-2, shape).astype(dtype))


def _t(x):
    return torch.tensor(x) if isinstance(x, np.ndarray) else x


DTYPES = [np.float32, np.float64]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("j", [1, 3, 6])
def test_stage_accum(dtype, shape, j):
    rng = np.random.default_rng(j)
    b, f = shape
    y, dt = rng.standard_normal((b, f)).astype(dtype), rng.uniform(-0.5, 0.5, b).astype(dtype)
    K, c = rng.standard_normal((j, b, f)).astype(dtype), rng.standard_normal(j).astype(dtype)
    want = _jax(lambda: jref.stage_accum(jnp.asarray(y), jnp.asarray(dt), jnp.asarray(K), c), dtype)
    _close(tref.stage_accum(_t(y), _t(dt), _t(K), c), want, dtype)
    _close(ops.stage_accum(_t(y), _t(dt), _t(K), c), want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("s", [2, 7])
def test_fused_update(dtype, shape, s):
    rng = np.random.default_rng(s)
    b, f = shape
    y, dt = rng.standard_normal((b, f)).astype(dtype), rng.uniform(-0.5, 0.5, b).astype(dtype)
    K = rng.standard_normal((s, b, f)).astype(dtype)
    bs, be = rng.standard_normal(s).astype(dtype), rng.standard_normal(s).astype(dtype)
    want = _jax(lambda: jref.fused_update(jnp.asarray(y), jnp.asarray(K), jnp.asarray(dt),
                                          jnp.asarray(bs), jnp.asarray(be)), dtype)
    for got in (tref.fused_update(_t(y), _t(K), _t(dt), bs, be),
                ops.fused_update(_t(y), _t(K), _t(dt), bs, be)):
        _close(got[0], want[0], dtype)
        _close(got[1], want[1], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["scalar", "row", "full"])
def test_broadcast_tolerances(dtype, kind):
    rng = np.random.default_rng(0)
    atol, rtol = _tol(kind, 4, 3, rng, dtype)
    want = _jax(lambda: jref.broadcast_tolerances(atol, rtol, dtype), dtype)
    got = tref.broadcast_tolerances(_t(atol), _t(rtol), torch.float64 if dtype == np.float64
                                    else torch.float32)
    for g, w in zip(got, want):
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", ["scalar", "row", "full"])
def test_error_norm(dtype, shape, kind):
    rng = np.random.default_rng(1)
    b, f = shape
    err, y0, y1 = (rng.standard_normal((b, f)).astype(dtype) * s for s in (1e-4, 1.0, 1.0))
    atol, rtol = _tol(kind, b, f, rng, dtype)
    want = _jax(lambda: jref.error_norm(jnp.asarray(err), jnp.asarray(y0), jnp.asarray(y1),
                                        atol, rtol), dtype)
    _close(tref.error_norm(_t(err), _t(y0), _t(y1), _t(atol), _t(rtol)), want, dtype)
    _close(ops.error_norm(_t(err), _t(y0), _t(y1), _t(atol), _t(rtol)), want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_rms_norm(dtype, shape):
    rng = np.random.default_rng(2)
    x, scale = rng.standard_normal(shape).astype(dtype), rng.uniform(0.1, 2, shape).astype(dtype)
    want = _jax(lambda: jref.rms_norm(jnp.asarray(x), jnp.asarray(scale)), dtype)
    _close(tref.rms_norm(_t(x), _t(scale)), want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_hermite_coeffs(dtype, shape):
    rng = np.random.default_rng(3)
    b, f = shape
    y0, y1, f0, f1 = (rng.standard_normal((b, f)).astype(dtype) for _ in range(4))
    dt = rng.uniform(-1, 1, b).astype(dtype)
    want = _jax(lambda: jref.hermite_coeffs(*map(jnp.asarray, (y0, y1, f0, f1, dt))), dtype)
    for g, w in zip(tref.hermite_coeffs(*map(_t, (y0, y1, f0, f1, dt))), want):
        _close(g, w, dtype)


PID_PARAMS = dict(b1=0.14, b2=-0.08, b3=0.02, safety=0.9, factor_min=0.2, factor_max=10.0,
                  dt_min=1e-3, dt_max=0.5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_pid_update(dtype):
    rng = np.random.default_rng(4)
    b = 64
    # Every branch: exact solve (0), accept, reject, non-finite, and the clamps.
    err = np.concatenate([[0.0, np.inf, np.nan, 1.0, 1e-12, 1e6],
                          rng.uniform(0, 3, b - 6)]).astype(dtype)
    dt = (rng.uniform(1e-4, 1.0, b) * np.where(rng.random(b) < 0.5, -1, 1)).astype(dtype)
    p1, p2 = rng.uniform(0.5, 2, b).astype(dtype), rng.uniform(0.5, 2, b).astype(dtype)
    want = _jax(lambda: jref.pid_update(*map(jnp.asarray, (err, dt, p1, p2)), **PID_PARAMS), dtype)
    got = tref.pid_update(*map(_t, (err, dt, p1, p2)), **PID_PARAMS)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    for g, w in zip(got[1:], want[1:]):
        _close(g, w, dtype)


def _interp_inputs(rng, b, n, f, dtype, mask_kind):
    coeffs = tuple(rng.standard_normal((b, f)).astype(dtype) for _ in range(4))
    x = rng.uniform(0, 1, (b, n)).astype(dtype)
    mask = {"none": np.zeros((b, n), bool), "all": np.ones((b, n), bool),
            "mixed": rng.random((b, n)) < 0.3}[mask_kind]
    out = rng.standard_normal((b, n, f)).astype(dtype)
    return coeffs, x, mask, out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mask_kind", ["none", "all", "mixed"])
def test_interp_eval(dtype, shape, mask_kind):
    b, f = shape
    coeffs, x, mask, out = _interp_inputs(np.random.default_rng(5), b, 7, f, dtype, mask_kind)
    want = _jax(lambda: jref.interp_eval(tuple(map(jnp.asarray, coeffs)), jnp.asarray(x),
                                         jnp.asarray(mask), jnp.asarray(out)), dtype)
    tc = tuple(map(_t, coeffs))
    _close(tref.interp_eval(tc, _t(x), _t(mask), _t(out)), want, dtype)
    _close(ops.interp_eval(tc, _t(x), _t(mask), _t(out)), want, dtype)


@pytest.mark.parametrize("mask_kind", ["none", "all", "mixed"])
def test_interp_eval_window(mask_kind):
    """The windowed write against the JAX package's composition of it in
    ``step.py`` (gather the window, ``interp_eval``, scatter it back)."""
    dtype = np.float32
    rng = np.random.default_rng(6)
    b, n, W, f = 6, 11, 4, 3
    coeffs, x, mask, _ = _interp_inputs(rng, b, W, f, dtype, mask_kind)
    out = rng.standard_normal((b, n, f)).astype(dtype)
    cursor = rng.integers(0, n - W + 1, b)

    def jax_window():
        ys, cur = jnp.asarray(out), jnp.asarray(cursor, jnp.int32)
        win = jax.vmap(lambda r, c: jax.lax.dynamic_slice(r, (c, 0), (W, f)))(ys, cur)
        merged = jref.interp_eval(tuple(map(jnp.asarray, coeffs)), jnp.asarray(x),
                                  jnp.asarray(mask), win)
        return jax.vmap(lambda r, m, c: jax.lax.dynamic_update_slice(r, m, (c, 0)))(
            ys, merged, cur)

    want = _jax(jax_window, dtype)
    got = ops.interp_eval(tuple(map(_t, coeffs)), _t(x), _t(mask), _t(out),
                          torch.as_tensor(cursor, dtype=torch.int64))
    _close(got, want, dtype)


class TestPallasInterpret:
    """One small case of each kernel op through the Pallas kernel in
    interpret mode (the JAX package's own CPU check of its kernels), called
    directly so the JAX package's backend choice is untouched."""

    def test_four_kernel_ops(self):
        impl = pallas_impl.interpret_impl()
        rng = np.random.default_rng(7)
        b, f, dtype = 5, 3, np.float32
        y, dt = rng.standard_normal((b, f)).astype(dtype), rng.uniform(0.1, 0.5, b).astype(dtype)
        K = rng.standard_normal((7, b, f)).astype(dtype)
        c = rng.standard_normal(7).astype(dtype)
        _close(tref.stage_accum(_t(y), _t(dt), _t(K[:3]), c[:3]),
               impl.stage_accum(y, dt, K[:3], c[:3]), dtype)
        y1, err = map(np.asarray, impl.fused_update(y, K, dt, c, c[::-1].copy()))
        got = tref.fused_update(_t(y), _t(K), _t(dt), c, c[::-1].copy())
        _close(got[0], y1, dtype)
        _close(got[1], err, dtype)
        atol = rng.uniform(1e-6, 1e-3, b).astype(dtype)
        _close(tref.error_norm(_t(err), _t(y), _t(y1), _t(atol), 1e-3),
               impl.error_norm(err, y, y1, atol, 1e-3), dtype)
        coeffs, x, mask, out = _interp_inputs(rng, b, 9, f, dtype, "mixed")
        _close(tref.interp_eval(tuple(map(_t, coeffs)), _t(x), _t(mask), _t(out)),
               impl.interp_eval(coeffs, x, mask, out), dtype)


class TestNoHiddenFallback:
    def test_cuda_wrappers_refuse_cpu_tensors(self):
        before = dict(ops.launches)
        y, dt, K = torch.ones(2, 3), torch.ones(2), torch.ones(1, 2, 3)
        with pytest.raises(ValueError, match="CUDA tensors"):
            cuda_impl.stage_accum(y, dt, K, [1.0])
        with pytest.raises(ValueError, match="CUDA tensors"):
            cuda_impl.fused_update(y, K, dt, [1.0], [0.0])
        with pytest.raises(ValueError, match="CUDA tensors"):
            cuda_impl.error_norm(y, y, y, 1e-6, 1e-3)
        coeffs = (y,) * 4
        with pytest.raises(ValueError, match="CUDA tensors"):
            cuda_impl.interp_eval(coeffs, torch.ones(2, 4), torch.ones(2, 4, dtype=torch.bool),
                                  torch.ones(2, 4, 3))
        assert ops.launches == before

    def test_cpu_dispatch_goes_to_plain_version(self):
        before = dict(ops.launches)
        y, dt, K = torch.ones(2, 3), torch.ones(2), torch.ones(1, 2, 3)
        torch.testing.assert_close(ops.stage_accum(y, dt, K, [2.0]), torch.full((2, 3), 3.0))
        assert ops.launches == before

    def test_unknown_device_raises(self):
        y = torch.ones(2, 3, device="meta")
        with pytest.raises(ValueError, match="no implementation"):
            ops.error_norm(y, y, y, 1e-6, 1e-3)
