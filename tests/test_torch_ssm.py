"""The port's Mamba block (``repro_torch.models.ssm``) against the JAX
package's ``models/ssm.py``, on the same weights (``mamba_params``) and
inputs from a seed, at the reduced jamba config.

- ``mamba_forward`` at s = 1, K - 1, 37, 64 and 300 (across the port's scan
  chunks of ``SCAN_CHUNK``), float32 at rtol 1e-4 / atol 1e-5;
- a chain of ``mamba_decode`` steps from ``mamba_init_state`` (outputs and
  states);
- ``mamba_prefill``'s state (the forward's final carry) against the
  reference's ``transformer._mamba_state_from_seq`` (a second scan);
- the chunked scan itself in float64: against ``jax.lax.associative_scan``
  of the same elements at 1e-10 (the two sum in different orders), and
  chunk sizes 1, 7 and 16 against one chunk at 1e-12.

The block's float64 path is float32 inside, in the reference as here (dt,
B, C and the scan are ``astype(jnp.float32)``): float64 inputs are held at
1e-5 of the output's largest entry.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

ARCH = "jamba_v0_1_52b"
RTOL, ATOL = 1e-4, 1e-5
B = 2


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def block():
    """(cfg, jcfg, the reference's weights as numpy, the port's block)."""
    cfg, jcfg = get_config(ARCH, reduced=True), jget_config(ARCH, reduced=True)
    p = {k: np.array(v) for k, v in jssm.mamba_params(jax.random.PRNGKey(0), jcfg,
                                                       jnp.float32).items()}
    m = ssm.Mamba(cfg, device="cpu")
    m.load_state_dict({k: torch.as_tensor(v) for k, v in p.items()})
    return cfg, jcfg, p, m


def _x(cfg, s, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((B, s, cfg.d_model)).astype(dtype)


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


def test_weights_are_the_references(block):
    cfg, _, p, m = block
    for name in ("A_log", "D", "dt_bias"):
        assert m[name].dtype == torch.float32
    fresh = ssm.Mamba(cfg, device="cpu")  # the constants as the reference makes them
    for name in ("D", "dt_bias", "conv_b"):
        np.testing.assert_array_equal(fresh[name].detach().numpy(), p[name])
    # log(1..N): XLA's float32 log of 7 is an ulp from ATen's
    np.testing.assert_allclose(fresh["A_log"].detach().numpy(), p["A_log"], rtol=2e-7, atol=0)


@pytest.mark.parametrize("s", [1, 3, 37, 64, 300])
def test_forward(block, s):
    cfg, jcfg, p, m = block
    x = _x(cfg, s, seed=s)
    with torch.no_grad():
        got = ssm.mamba_forward(cfg, m, torch.as_tensor(x))
    _close(got, jssm.mamba_forward(jcfg, _j(p), jnp.asarray(x)))


@pytest.mark.parametrize("s", [1, 3, 37, 300])
def test_prefill_state(block, s):
    cfg, jcfg, p, m = block
    x = _x(cfg, s, seed=10 + s)
    with torch.no_grad():
        y, state = ssm.mamba_prefill(cfg, m, torch.as_tensor(x))
    _close(y, jssm.mamba_forward(jcfg, _j(p), jnp.asarray(x)))
    want = jtransformer._mamba_state_from_seq(jcfg, _j(p), jnp.asarray(x))
    assert state["conv"].shape == (B, cfg.ssm_conv - 1, cfg.d_inner)
    assert state["h"].dtype == torch.float32
    _close(state["h"], want["h"])
    if s >= cfg.ssm_conv - 1:  # the reference's window is its last s rows below that
        _close(state["conv"], want["conv"], rtol=0, atol=0)
    else:
        assert not state["conv"][:, :cfg.ssm_conv - 1 - s].any()
        _close(state["conv"][:, cfg.ssm_conv - 1 - s:], want["conv"], rtol=0, atol=0)


def test_decode_chain(block):
    cfg, jcfg, p, m = block
    x = _x(cfg, 12, seed=20)
    st = ssm.mamba_init_state(cfg, B, torch.float32, "cpu")
    jst = jssm.mamba_init_state(jcfg, B, jnp.float32)
    for t in range(x.shape[1]):
        with torch.no_grad():
            y, st = ssm.mamba_decode(cfg, m, torch.as_tensor(x[:, t]), st)
        jy, jst = jssm.mamba_decode(jcfg, _j(p), jnp.asarray(x[:, t]), jst)
        _close(y, jy)
        for name in ("h", "conv"):
            _close(st[name], jst[name])


def test_decode_continues_prefill(block):
    """prefill(s) then decode steps == prefill(s + n), the port alone."""
    cfg, _, _, m = block
    x = torch.as_tensor(_x(cfg, 40, seed=21))
    with torch.no_grad():
        full = ssm.mamba_forward(cfg, m, x)
        _, st = ssm.mamba_prefill(cfg, m, x[:, :33])
        for t in range(33, 40):
            y, st = ssm.mamba_decode(cfg, m, x[:, t], st)
            torch.testing.assert_close(y, full[:, t], rtol=RTOL, atol=ATOL)


def test_float64_inputs(block):
    cfg, jcfg, p, m = block
    x = _x(cfg, 37, seed=30, dtype=np.float64)
    with jax.enable_x64(True):
        p64 = {k: np.array(v) for k, v in jssm.mamba_params(jax.random.PRNGKey(1), jcfg,
                                                             jnp.float64).items()}
        want = np.asarray(jssm.mamba_forward(jcfg, _j(p64), jnp.asarray(x)))
    m64 = ssm.Mamba(cfg, device="cpu", dtype=torch.float64)
    m64.load_state_dict({k: torch.as_tensor(v) for k, v in p64.items()})
    with torch.no_grad():
        got = ssm.mamba_forward(cfg, m64, torch.as_tensor(x)).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def _scan_inputs(s, di=6, n=5, seed=40):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, s, di))))  # softplus: positive
    A = -np.broadcast_to(np.arange(1, n + 1, dtype=np.float64), (di, n)).copy()
    Bm, Cm, u = (rng.standard_normal(shape) for shape in ((B, s, n), (B, s, n), (B, s, di)))
    return dt, A, Bm, Cm, u


@pytest.mark.parametrize("s", [1, 37, 300])
def test_scan_float64_against_associative_scan(s):
    dt, A, Bm, Cm, u = _scan_inputs(s)
    with jax.enable_x64(True):
        dA = jnp.exp(jnp.asarray(dt)[..., None] * A)
        dBu = jnp.asarray(dt * u)[..., None] * jnp.asarray(Bm)[..., None, :]
        _, h = jax.lax.associative_scan(lambda l, r: (l[0] * r[0], l[1] * r[0] + r[1]),
                                        (dA, dBu), axis=1)
        want_y = np.asarray(jnp.einsum("bsdn,bsn->bsd", h, jnp.asarray(Cm)))
        want_h = np.asarray(h[:, -1])
    y, hl = ssm._scan(*(torch.as_tensor(a) for a in (dt, A, Bm, Cm, u)))
    np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(hl.numpy(), want_h, rtol=1e-10, atol=1e-10)
    for chunk in (1, 7, 16):
        yc, hc = ssm._scan(*(torch.as_tensor(a) for a in (dt, A, Bm, Cm, u)), chunk=chunk)
        torch.testing.assert_close(yc, y, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(hc, hl, rtol=1e-12, atol=1e-12)
