"""The plain ``error_norm`` on rows wider than its CUDA row body holds
(``cuda_impl.NORM_ROW_MAX_F``), where the card runs the wide body: against
the JAX package's plain op on the same numpy inputs at (b, f) = (2, 40 000)
and (1, 4097), every tolerance shape (``dense_checks.TOL_KINDS``).  The wide
body is held bitwise to the warp body, and so to the fused step's ratio, on
the card (``test_torch_kernels_card.py``).

TOL: relative, 1e-6 in float32 and 1e-13 in float64: the two sum their
squares over the row in other orders.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import cuda_impl  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.tools import dense_checks  # noqa: E402

TOL = {np.float32: 1e-6, np.float64: 1e-13}
SHAPES = [(2, 40_000), (1, 4097)]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _t(x):
    return torch.tensor(x) if isinstance(x, np.ndarray) else x


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("b, f", SHAPES)
@pytest.mark.parametrize("kind", dense_checks.TOL_KINDS)
def test_error_norm_wide_rows(dtype, b, f, kind):
    assert cuda_impl.error_norm_body(f) == "wide"
    err, y0, y1, atol, rtol = dense_checks.norm_inputs(f + b, b, f, dtype, kind)
    got = tref.error_norm(_t(err), _t(y0), _t(y1), _t(atol), _t(rtol)).numpy()
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jref.error_norm(jnp.asarray(err), jnp.asarray(y0), jnp.asarray(y1),
                                          atol, rtol))
    assert got.shape == want.shape == (b,) and got.dtype == want.dtype
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=0)
