"""The plain ``error_norm`` and ``interp_eval`` at the boundaries of their
CUDA kernels' layouts (``repro_torch.tools.dense_checks``: widths of rows
sharing a block, around a warp and full_width's 784; every tolerance shape; every
mask kind), against the JAX package's plain ops and its Pallas kernels in
interpret mode on the same numpy inputs.  The CUDA kernels are held to these
plain versions, bitwise for ``interp_eval``, at the same widths on the card
(``test_torch_kernels_card.py``).

TOL: float32 at rtol = atol = 1e-6, float64 at 1e-12.  ``error_norm``'s
three versions sum their squares in other orders (the Pallas kernel by
128-wide tiles), and XLA may contract Horner's multiply-adds, so both are
held to rounding, not bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import pallas_impl  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.tools import dense_checks  # noqa: E402

TOL = {np.float32: 1e-6, np.float64: 1e-12}
DTYPES = [np.float32, np.float64]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _close(t, j, dtype):
    t = t.detach().cpu().numpy()
    j = np.asarray(j)
    assert t.shape == j.shape and t.dtype == j.dtype
    np.testing.assert_allclose(t, j, rtol=TOL[dtype], atol=TOL[dtype])


def _jax(fn, dtype):
    """Run ``fn`` with JAX in the dtype's precision; numpy results out."""
    with jax.enable_x64(dtype == np.float64):
        return jax.tree_util.tree_map(np.asarray, fn())


def _t(x):
    return torch.tensor(x) if isinstance(x, np.ndarray) else x


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("f", dense_checks.ERROR_NORM_WIDTHS)
@pytest.mark.parametrize("kind", dense_checks.TOL_KINDS)
def test_error_norm_widths(dtype, f, kind):
    """Every tolerance shape at every width."""
    err, y0, y1, atol, rtol = dense_checks.norm_inputs(f, 5, f, dtype, kind)
    got = tref.error_norm(_t(err), _t(y0), _t(y1), _t(atol), _t(rtol))
    _close(got, _jax(lambda: jref.error_norm(jnp.asarray(err), jnp.asarray(y0),
                                             jnp.asarray(y1), atol, rtol), dtype), dtype)
    impl = pallas_impl.interpret_impl()
    _close(got, _jax(lambda: impl.error_norm(err, y0, y1, atol, rtol), dtype), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("f", dense_checks.ERROR_NORM_WIDTHS)
@pytest.mark.parametrize("kind", dense_checks.MASK_KINDS)
def test_interp_eval_widths(dtype, f, kind):
    """Every mask kind at every width; the unmasked cells keep ``out``'s
    values exactly."""
    coeffs, x, mask, out = dense_checks.interp_inputs(f, 5, 9, f, dtype, kind)
    got = tref.interp_eval(tuple(map(_t, coeffs)), _t(x), _t(mask), _t(out))
    _close(got, _jax(lambda: jref.interp_eval(tuple(map(jnp.asarray, coeffs)), jnp.asarray(x),
                                              jnp.asarray(mask), jnp.asarray(out)), dtype),
           dtype)
    impl = pallas_impl.interpret_impl()
    _close(got, _jax(lambda: impl.interp_eval(coeffs, x, mask, out), dtype), dtype)
    assert torch.equal(got[~_t(mask)], _t(out)[~_t(mask)])
