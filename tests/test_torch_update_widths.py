"""The plain ``fused_update`` (and ``ops.fused_update`` on CPU tensors) at
the boundaries of its CUDA kernel's layout (``repro_torch.tools.dense_checks``:
``UPDATE_SHAPES``, rows sharing a block, around a warp's chunks and
full_width's 784, a row wider than a block), with every tableau's weights and
random weights at every stage count the kernel instantiates (1..8), against
the JAX package's plain op and its Pallas kernel in interpret mode on the
same numpy inputs.  The CUDA kernel is held to this plain version at the same
shapes and weights on the card (``test_torch_kernels_card.py``).

TOL: float32 at rtol = atol = 1e-6, float64 at 1e-12: the three versions
sum the stages in other orders (the plain versions through a tensordot).
The Pallas kernel, which compiles once per shape and weights, runs each
weights case at one of the shapes in turn, so every shape meets it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import pallas_impl  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
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


def _close(got, want, dtype):
    for t, j in zip(got, want):
        t, j = t.detach().numpy(), np.asarray(j)
        assert t.shape == j.shape and t.dtype == j.dtype
        np.testing.assert_allclose(t, j, rtol=TOL[dtype], atol=TOL[dtype])


def _jax(fn, dtype):
    """Run ``fn`` with JAX in the dtype's precision; numpy results out."""
    with jax.enable_x64(dtype == np.float64):
        return jax.tree_util.tree_map(np.asarray, fn())


def _inputs(b, f, weights, dtype):
    b_sol, b_err = dense_checks.update_weights(weights)
    y, K, dt = dense_checks.update_inputs(b * f + len(b_sol), b, f, len(b_sol), dtype)
    return y, K, dt, b_sol, b_err


def _plain(y, K, dt, b_sol, b_err):
    """The port's plain op and its CPU dispatch, on the same inputs."""
    args = (torch.from_numpy(y), torch.from_numpy(K), torch.from_numpy(dt), b_sol, b_err)
    return tref.fused_update(*args), ops.fused_update(*args)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b, f", dense_checks.UPDATE_SHAPES)
@pytest.mark.parametrize("weights", dense_checks.UPDATE_WEIGHTS)
def test_against_jax_ref(dtype, b, f, weights):
    y, K, dt, b_sol, b_err = _inputs(b, f, weights, dtype)
    want = _jax(lambda: jref.fused_update(jnp.asarray(y), jnp.asarray(K), jnp.asarray(dt),
                                          jnp.asarray(b_sol), jnp.asarray(b_err)), dtype)
    for got in _plain(y, K, dt, b_sol, b_err):
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("weights", dense_checks.UPDATE_WEIGHTS)
def test_against_pallas_interpret(dtype, weights):
    i = dense_checks.UPDATE_WEIGHTS.index(weights) + DTYPES.index(dtype)
    b, f = dense_checks.UPDATE_SHAPES[i % len(dense_checks.UPDATE_SHAPES)]
    y, K, dt, b_sol, b_err = _inputs(b, f, weights, dtype)
    impl = pallas_impl.interpret_impl()
    want = _jax(lambda: impl.fused_update(y, K, dt, b_sol, b_err), dtype)
    for got in _plain(y, K, dt, b_sol, b_err):
        _close(got, want, dtype)

