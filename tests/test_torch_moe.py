"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``moe_apply``, called outside a mesh (its single-device path,
``_moe_apply_gspmd``), on the same weights and tokens from a seed.

Output and ``moe_balance`` at the reduced deepseek-moe-16b, kimi-k2 and
jamba MoE configs, at capacity factors where tokens drop (0.5, 1.25), with
``capacity = T`` (decode's), with tied router columns (``jax.lax.top_k``
puts the lower expert first), with 0, 1 and 2 shared experts; float32 at
rtol 1e-4 / atol 1e-5.  Float64 inputs: the reference routes in float32
(``moe.py``: the router's logits ``astype(jnp.float32)``), so the routing
weights carry float32 rounding into the float64 output, and the float64
case is held at 1e-6 relative to the output's largest entry.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ARCHS = ["deepseek_moe_16b", "kimi_k2_1t_a32b", "jamba_v0_1_52b"]
RTOL, ATOL = 1e-4, 1e-5
T = 48


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _cfgs(arch, **moe_kw):
    cfg, jcfg = get_config(arch, reduced=True), jget_config(arch, reduced=True)
    if moe_kw:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe_kw))
    return cfg, jcfg


def _layer(cfg, jcfg, dtype=np.float32, seed=0, edit=None):
    """The reference's weights (``moe_params``) and the port's layer holding
    them, and tokens (T, d) from ``seed``; ``edit(params)`` may change the
    numpy weights first."""
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    p = {k: np.array(v) for k, v in jmoe.moe_params(jax.random.PRNGKey(seed), jcfg, jdt).items()}
    if edit is not None:
        edit(p)
    layer = moe.MoE(cfg, device="cpu", dtype=getattr(torch, np.dtype(dtype).name))
    layer.load_state_dict({k: torch.as_tensor(v) for k, v in p.items()})
    x = np.random.default_rng(seed + 1).standard_normal((T, cfg.d_model)).astype(dtype)
    return p, layer, x


def _run(cfg, jcfg, p, layer, x, capacity=None):
    with torch.no_grad():
        got, aux = layer(torch.as_tensor(x), capacity=capacity)
    want, jaux = jmoe.moe_apply(jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                capacity=capacity)
    return got.numpy(), float(aux["moe_balance"]), np.asarray(want), float(jaux["moe_balance"])


def _hold(cfg, jcfg, p, layer, x, capacity=None):
    got, bal, want, jbal = _run(cfg, jcfg, p, layer, x, capacity)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(bal, jbal, rtol=RTOL)


def _dropped(cfg, layer, x):
    """The share of (token, expert) assignments past capacity."""
    with torch.no_grad():
        _, _, topi = moe.route(cfg, layer, torch.as_tensor(x))
    counts = torch.bincount(topi.reshape(-1), minlength=cfg.moe.n_experts)
    C = moe.expert_capacity(cfg, x.shape[0])
    return float((counts - C).clamp(min=0).sum()) / topi.numel()


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_configs(arch):
    cfg, jcfg = _cfgs(arch)
    _hold(cfg, jcfg, *_layer(cfg, jcfg))


@pytest.mark.parametrize("factor", [0.5, 1.25])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops(arch, factor):
    """At the first seed from 3 whose tokens overflow an expert."""
    cfg, jcfg = _cfgs(arch, capacity_factor=factor)
    p, layer, x = next(case for case in (_layer(cfg, jcfg, seed=s) for s in range(3, 23))
                       if _dropped(cfg, case[1], case[2]) > 0)
    _hold(cfg, jcfg, p, layer, x)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_is_tokens(arch):
    cfg, jcfg = _cfgs(arch, capacity_factor=0.5)
    p, layer, x = _layer(cfg, jcfg, seed=4)
    _hold(cfg, jcfg, p, layer, x, capacity=T)
    _hold(cfg, jcfg, p, layer, x[:3], capacity=3)  # a decode step's few tokens


@pytest.mark.parametrize("tie", ["two", "all"])
@pytest.mark.parametrize("arch", ARCHS)
def test_tied_router_columns(arch, tie):
    """Equal probabilities: the lower expert is taken first.  "two": expert
    3 is a copy of expert 1's router column; "all": every column equal, so
    that every token must go to experts 0..k-1 (and drops follow)."""
    cfg, jcfg = _cfgs(arch, capacity_factor=1.25)

    def edit(p):
        if tie == "two":
            p["router"][:, 3] = p["router"][:, 1]
        else:
            p["router"][:] = p["router"][:, :1]

    p, layer, x = _layer(cfg, jcfg, seed=5, edit=edit)
    with torch.no_grad():
        _, _, topi = moe.route(cfg, layer, torch.as_tensor(x))
    if tie == "all":
        assert (topi == torch.arange(cfg.moe.top_k)).all()
    else:
        assert bool(((topi == 1) | (topi == 3)).any())
    _hold(cfg, jcfg, p, layer, x)


@pytest.mark.parametrize("n_shared", [0, 1, 2])
def test_shared_experts(n_shared):
    cfg, jcfg = _cfgs("deepseek_moe_16b", n_shared=n_shared, capacity_factor=1.25)
    p, layer, x = _layer(cfg, jcfg, seed=6)
    assert ("shared_in" in p) == (n_shared > 0) and ("shared_in" in layer) == (n_shared > 0)
    _hold(cfg, jcfg, p, layer, x)


@pytest.mark.parametrize("arch", ARCHS)
def test_float64(arch):
    cfg, jcfg = _cfgs(arch, capacity_factor=1.25)
    with jax.enable_x64(True):
        p, layer, x = _layer(cfg, jcfg, dtype=np.float64, seed=7)
        assert layer["router"].dtype == torch.float32 and layer["w_in"].dtype == torch.float64
        got, bal, want, jbal = _run(cfg, jcfg, p, layer, x)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(bal, jbal, rtol=1e-6)


def test_expert_capacity_is_the_references():
    for arch in ARCHS:
        cfg = get_config(arch)
        for t in (1, 4, 4096, 8192):
            want = max(1, int(cfg.moe.capacity_factor * cfg.moe.top_k * t / cfg.moe.n_experts))
            assert moe.expert_capacity(cfg, t) == want
        # capacity_factor = E / k leaves room for every token (C = T): the
        # full-width prefill/decode check runs at it
        e, k = cfg.moe.n_experts, cfg.moe.top_k
        assert moe.expert_capacity(
            dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=e / k)),
            8192) == 8192
