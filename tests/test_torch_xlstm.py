"""The port's xLSTM blocks (``repro_torch.models.xlstm``) against the JAX
package's ``models/xlstm.py``, on the same weights (``mlstm_params``,
``slstm_params``) and inputs from a seed, at the reduced xlstm-350m config;
float32 at rtol 1e-4 / atol 1e-5.

- ``mlstm_forward`` with chunks of 16 at s = 8, 16 and 48 (below, equal to
  and three times the chunk), and at s = 37 with the default chunk (one
  chunk of 37); the reference's ``s % L == 0`` assertion;
- ``mlstm_decode`` chains from ``mlstm_init_state`` (outputs and states);
- ``slstm_forward`` (the input half of the gates taken out of the token
  loop) and ``slstm_decode`` chains, and the cell itself;
- both prefill states (the forward's final carry) against the reference's
  ``transformer._mlstm_state_from_seq`` / ``_slstm_state_from_seq`` (a
  decode recursion over the whole prompt), within 1e-5 of each state
  tensor's largest entry.

Both blocks compute in float32 whatever the input, in the reference as here
(``astype(jnp.float32)``): the float64 case is held at 1e-5 of the output's
largest entry.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import xlstm  # noqa: E402

ARCH = "xlstm_350m"
RTOL, ATOL = 1e-4, 1e-5
B = 2


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _cfgs():
    return get_config(ARCH, reduced=True), jget_config(ARCH, reduced=True)


def _load(cls, jparams, cfg, key, dtype=jnp.float32):
    p = {k: np.array(v) for k, v in jparams(jax.random.PRNGKey(key), _cfgs()[1], dtype).items()}
    m = cls(cfg, device="cpu", dtype=torch.float64 if dtype == jnp.float64 else None)
    m.load_state_dict({k: torch.as_tensor(v) for k, v in p.items()})
    return p, m


@pytest.fixture(scope="module")
def mlstm():
    cfg, jcfg = _cfgs()
    return (cfg, jcfg) + _load(xlstm.MLSTM, jxlstm.mlstm_params, cfg, 0)


@pytest.fixture(scope="module")
def slstm():
    cfg, jcfg = _cfgs()
    return (cfg, jcfg) + _load(xlstm.SLSTM, jxlstm.slstm_params, cfg, 1)


def _x(cfg, s, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((B, s, cfg.d_model)).astype(dtype)


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


def _state_close(got, want):
    for name, w in want.items():
        w = np.asarray(w)
        _close(got[name], w, rtol=1e-5, atol=1e-5 * np.abs(w).max())


def test_gate_weights_are_float32(mlstm):
    _, _, _, m = mlstm
    assert m["wi"].dtype == m["wf"].dtype == torch.float32


@pytest.mark.parametrize("s,chunk", [(8, 16), (16, 16), (48, 16), (37, 256)])
def test_mlstm_forward(mlstm, s, chunk):
    cfg, jcfg, p, m = mlstm
    x = _x(cfg, s, seed=s)
    with torch.no_grad():
        got = xlstm.mlstm_forward(cfg, m, torch.as_tensor(x), chunk=chunk)
    _close(got, jxlstm.mlstm_forward(jcfg, _j(p), jnp.asarray(x), chunk=chunk))


def test_mlstm_chunk_must_divide(mlstm):
    cfg, _, _, m = mlstm
    with pytest.raises(AssertionError):
        xlstm.mlstm_forward(cfg, m, torch.as_tensor(_x(cfg, 40, seed=1)), chunk=16)


@pytest.mark.parametrize("s,chunk", [(16, 16), (48, 16), (37, 256)])
def test_mlstm_prefill_state(mlstm, s, chunk):
    cfg, jcfg, p, m = mlstm
    x = _x(cfg, s, seed=50 + s)
    with torch.no_grad():
        _, state = xlstm.mlstm_prefill(cfg, m, torch.as_tensor(x), chunk=chunk)
    _state_close(state, jtransformer._mlstm_state_from_seq(jcfg, _j(p), jnp.asarray(x)))


def test_mlstm_decode_chain(mlstm):
    cfg, jcfg, p, m = mlstm
    x = _x(cfg, 10, seed=60)
    st, jst = xlstm.mlstm_init_state(cfg, B, "cpu"), jxlstm.mlstm_init_state(jcfg, B)
    for t in range(x.shape[1]):
        with torch.no_grad():
            y, st = xlstm.mlstm_decode(cfg, m, torch.as_tensor(x[:, t]), st)
        jy, jst = jxlstm.mlstm_decode(jcfg, _j(p), jnp.asarray(x[:, t]), jst)
        _close(y, jy)
        _state_close(st, jst)


def test_slstm_forward_and_prefill_state(slstm):
    cfg, jcfg, p, m = slstm
    x = _x(cfg, 37, seed=70)
    with torch.no_grad():
        got, state = xlstm.slstm_prefill(cfg, m, torch.as_tensor(x))
        torch.testing.assert_close(xlstm.slstm_forward(cfg, m, torch.as_tensor(x)), got)
    _close(got, jxlstm.slstm_forward(jcfg, _j(p), jnp.asarray(x)))
    _state_close(state, jtransformer._slstm_state_from_seq(jcfg, _j(p), jnp.asarray(x)))


def test_slstm_cell_and_decode_chain(slstm):
    cfg, jcfg, p, m = slstm
    x = _x(cfg, 10, seed=80)
    st, jst = xlstm.slstm_init_state(cfg, B, device="cpu"), jxlstm.slstm_init_state(jcfg, B,
                                                                                    jnp.float32)
    for t in range(x.shape[1]):
        with torch.no_grad():
            cell = xlstm._slstm_cell(m, torch.as_tensor(x[:, t]), st)
            y, st = xlstm.slstm_decode(cfg, m, torch.as_tensor(x[:, t]), st)
        _state_close(cell, jxlstm._slstm_cell(_j(p), jnp.asarray(x[:, t]), jst))
        jy, jst = jxlstm.slstm_decode(jcfg, _j(p), jnp.asarray(x[:, t]), jst)
        _close(y, jy)
        _state_close(st, jst)


def test_decode_continues_prefill(mlstm, slstm):
    """prefill(s) then decode steps == forward(s + n), the port alone."""
    for forward, prefill, decode, (cfg, _, _, m) in (
            (xlstm.mlstm_forward, xlstm.mlstm_prefill, xlstm.mlstm_decode, mlstm),
            (xlstm.slstm_forward, xlstm.slstm_prefill, xlstm.slstm_decode, slstm)):
        x = torch.as_tensor(_x(cfg, 40, seed=90))
        with torch.no_grad():
            full = forward(cfg, m, x)
            _, st = prefill(cfg, m, x[:, :32])
            for t in range(32, 40):
                y, st = decode(cfg, m, x[:, t], st)
                torch.testing.assert_close(y, full[:, t], rtol=RTOL, atol=ATOL)


def test_float64_inputs():
    cfg, jcfg = _cfgs()
    x = _x(cfg, 32, seed=100, dtype=np.float64)
    with jax.enable_x64(True):
        for cls, params, fwd, jfwd in ((xlstm.MLSTM, jxlstm.mlstm_params, xlstm.mlstm_forward,
                                        jxlstm.mlstm_forward),
                                       (xlstm.SLSTM, jxlstm.slstm_params, xlstm.slstm_forward,
                                        jxlstm.slstm_forward)):
            p, m = _load(cls, params, cfg, 2, jnp.float64)
            want = np.asarray(jfwd(jcfg, _j(p), jnp.asarray(x)))
            with torch.no_grad():
                got = fwd(cfg, m, torch.as_tensor(x)).numpy()
            assert got.dtype == np.float64
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
