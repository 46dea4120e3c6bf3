"""Whole solves of the port (``repro_torch.core.solve_ivp``, on the CPU)
against the JAX package's ``repro.core.solve_ivp`` on the same numpy inputs.

The base case is Van der Pol, mu = 2, b = 16, 200 eval points over one cycle
at atol = rtol = 1e-5 (``benchmarks/vdp_bench.py`` at a smaller batch), with
variations of state structure, time spans, tolerances, layout and method.
Compared: ``ts``, ``ys``, ``status`` and the stats ``n_steps``,
``n_accepted``, ``n_f_evals`` and ``n_initialized``.

float64: the counts are equal and ``ts``/``ys`` agree to 1e-9.

float32: the two frameworks round differently at the level of single ulps
(XLA's ``pow`` is its own approximation: about 1 float32 result in 80 differs
by an ulp from ATen's, so the initial step and every controller decision
start an ulp apart).  At tol 1e-5 the embedded error estimate is a sum of
stage slopes that cancels to ~1e-5 of their size, so an ulp in the inputs
moves ``err_ratio`` by about 1 % and a decision near ``err_ratio = 1`` can
flip.  A flip changes the instance's step sequence and moves its dense output
by up to the solver's own global error.  So in float32: ``ts`` and
``status`` are equal, per-instance step counts agree within 10 %, and ``ys``
agree within the reference's own float32 global error at this tolerance
(its distance to a float64 solve at tol 1e-10), and never looser than 1e-4.
The measured gaps are written in CHANGES.md.
"""

import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch import convert  # noqa: E402

B, N, MU = 16, 200, 2.0
T_CYCLE = float((3.0 - 2.0 * np.log(2.0)) * MU + 2 * np.pi / MU ** (1 / 3))
COUNTS = ("n_steps", "n_accepted", "n_f_evals", "n_initialized")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _jax_ns():
    return types.SimpleNamespace(stack=lambda xs: jnp.stack(xs, axis=-1), tanh=jnp.tanh,
                                 core=J, kw={},
                                 params=lambda w: {k: jnp.asarray(v) for k, v in w.items()})


def _torch_ns():
    return types.SimpleNamespace(stack=lambda xs: torch.stack(xs, dim=-1), tanh=torch.tanh,
                                 core=T, kw={"device": "cpu"},
                                 params=lambda w: convert.from_numpy(w, "cpu"))


def _vdp(xp):
    def f(t, y, mu):
        x, v = y[..., 0], y[..., 1]
        return xp.stack((v, mu * (1 - x**2) * v - x))
    return f


def _y0(dtype):
    rng = np.random.default_rng(0)
    return (np.array([2.0, 0.0]) + 0.1 * rng.standard_normal((B, 2))).astype(dtype)


def _te(dtype, end=T_CYCLE):
    return np.linspace(0.0, end, N).astype(dtype)


# Each case: fn(xp, dtype, tol) -> Solution, and the float32 yardstick's
# truth: a float64 solve of the case at tol 1e-10 ("tight"), of another case
# that solves the same problem (its name), or of the same configuration in
# float64 ("same": fixed-step schemes, whose discrete solution is the
# reference, and max_steps cuts, which stop before the end).
CASES = {}


def _case(name, truth="tight"):
    def deco(fn):
        CASES[name] = (fn, truth)
        return fn
    return deco


for _m in ("dopri5", "tsit5"):
    _case(f"base_{_m}")(
        lambda xp, dt, tol, m=_m: xp.core.solve_ivp(
            _vdp(xp), _y0(dt), _te(dt), method=m, atol=tol, rtol=tol, args=MU, **xp.kw))


@_case("pytree_state")
def _pytree(xp, dt, tol):
    y = _y0(dt)

    def f(t, s, mu):
        return {"x": s["v"], "v": mu * (1 - s["x"] ** 2) * s["v"] - s["x"]}

    return xp.core.solve_ivp(f, {"x": y[:, :1], "v": y[:, 1:]}, _te(dt), atol=tol, rtol=tol,
                             args=MU, **xp.kw)


@_case("per_instance_t_eval")
def _per_instance_t_eval(xp, dt, tol):
    ends = np.linspace(0.5, 1.0, B) * T_CYCLE
    tev = np.stack([np.linspace(0.0, e, N) for e in ends]).astype(dt)
    return xp.core.solve_ivp(_vdp(xp), _y0(dt), tev, atol=tol, rtol=tol, args=MU, **xp.kw)


# Backward VdP leaves the (attracting) limit cycle and blows up within about
# one time unit, so the backward spans are one time unit long.
@_case("backward")
def _backward(xp, dt, tol):
    return xp.core.solve_ivp(_vdp(xp), _y0(dt), _te(dt, 1.0)[::-1].copy(), atol=tol, rtol=tol,
                             args=MU, **xp.kw)


@_case("mixed_direction")
def _mixed(xp, dt, tol):
    sign = np.where(np.arange(B) % 2 == 0, 1.0, -1.0)
    tev = (sign[:, None] * np.linspace(0.0, 1.0, N)[None]).astype(dt)
    return xp.core.solve_ivp(_vdp(xp), _y0(dt), tev, atol=tol, rtol=tol, args=MU, **xp.kw)


@_case("per_instance_tol")
def _per_instance_tol(xp, dt, tol):
    tols = (np.logspace(-1, 1, B) * tol).astype(dt)
    return xp.core.solve_ivp(_vdp(xp), _y0(dt), _te(dt), atol=tols, rtol=tols, args=MU, **xp.kw)


@_case("dense_false")
def _dense_false(xp, dt, tol):
    return xp.core.solve_ivp(_vdp(xp), _y0(dt), None, t_start=0.0, t_end=T_CYCLE, atol=tol,
                             rtol=tol, args=MU, dense=False, **xp.kw)


@_case("dense_window", truth="base_dopri5")
def _dense_window(xp, dt, tol):
    return xp.core.solve_ivp(_vdp(xp), _y0(dt), _te(dt), atol=tol, rtol=tol, args=MU,
                             dense_window=8, **xp.kw)


@_case("unbatched_term")
def _unbatched(xp, dt, tol):
    def f(t, y, mu):
        return xp.stack((y[1], mu * (1 - y[0] ** 2) * y[1] - y[0]))

    return xp.core.solve_ivp(f, _y0(dt), _te(dt), atol=tol, rtol=tol, args=MU,
                             batched_term=False, **xp.kw)


for _m in ("euler", "heun", "rk4"):
    _case(f"fixed_{_m}", truth="same")(
        lambda xp, dt, tol, m=_m: xp.core.solve_ivp(
            _vdp(xp), _y0(dt), _te(dt, 2.0), method=m, controller=xp.core.FixedController(),
            dt0=0.02, args=MU, **xp.kw))


@_case("max_steps_cut", truth="same")
def _max_steps(xp, dt, tol):
    return xp.core.solve_ivp(_vdp(xp), _y0(dt), _te(dt), atol=tol, rtol=tol, args=MU,
                             max_steps=25, **xp.kw)


@_case("mlp_weights_from_numpy")
def _mlp(xp, dt, tol):
    rng = np.random.default_rng(3)
    f, h = 8, 16
    w = {"w1": rng.standard_normal((f, h)) / np.sqrt(f), "b1": 0.1 * rng.standard_normal(h),
         "w2": rng.standard_normal((h, f)) / np.sqrt(h), "b2": 0.1 * rng.standard_normal(f)}
    w = xp.params({k: v.astype(dt) for k, v in w.items()})
    y0 = rng.standard_normal((B, f)).astype(dt)

    def vf(t, y, p):
        return xp.tanh(y @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]

    return xp.core.solve_ivp(vf, y0, np.linspace(0.0, 2.0, 20).astype(dt), atol=tol / 10,
                             rtol=tol / 10, args=w, **xp.kw)


def _flat(ys):
    """ys as one array: structured states concatenated leaf by leaf."""
    if isinstance(ys, dict):
        return np.concatenate([np.asarray(ys[k]) for k in sorted(ys)], axis=-1)
    return np.asarray(ys)


def _numpy(sol):
    return dict(ts=np.asarray(sol.ts), ys=_flat(sol.ys), status=np.asarray(sol.status),
                **{k: np.asarray(sol.stats[k]) for k in COUNTS})


_JAX_CACHE = {}


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's solves, computed once per (case, dtype, tol)."""
    def get(name, dtype, tol=1e-5):
        key = (name, dtype, tol)
        if key not in _JAX_CACHE:
            with jax.enable_x64(dtype == np.float64):
                _JAX_CACHE[key] = _numpy(CASES[name][0](_jax_ns(), dtype, tol))
        return _JAX_CACHE[key]
    yield get
    _JAX_CACHE.clear()


def _port(name, dtype):
    return _numpy(convert.to_numpy(CASES[name][0](_torch_ns(), dtype, 1e-5)))


# dense_window > 0 raises TypeError in the JAX package under x64 (ROADMAP
# C-4), so that case has no float64 reference.
@pytest.mark.parametrize("name", [n for n in CASES if n != "dense_window"])
def test_float64_matches_reference(name, jax_ref):
    want, got = jax_ref(name, np.float64), _port(name, np.float64)
    np.testing.assert_array_equal(got["status"], want["status"])
    for k in COUNTS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["ts"], want["ts"], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got["ys"], want["ys"], rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("name", list(CASES))
def test_float32_matches_reference(name, jax_ref):
    want, got = jax_ref(name, np.float32), _port(name, np.float32)
    spec = CASES[name][1]
    if spec == "same":
        truth = jax_ref(name, np.float64)
    else:
        truth = jax_ref(name if spec == "tight" else spec, np.float64, 1e-10)
    np.testing.assert_array_equal(got["status"], want["status"])
    np.testing.assert_allclose(got["ts"], want["ts"], rtol=1e-6, atol=1e-6)
    for k in ("n_steps", "n_accepted"):
        allowed = np.ceil(0.1 * want[k])
        assert np.all(np.abs(got[k].astype(int) - want[k]) <= allowed), (k, got[k], want[k])
    done = want["status"] == 0
    np.testing.assert_array_equal(got["n_initialized"][done], want["n_initialized"][done])
    global_err = np.abs(want["ys"] - truth["ys"]).max()
    gap = np.abs(got["ys"] - want["ys"]).max()
    assert gap <= max(1e-4, global_err), (gap, global_err)


def test_float32_flips_are_the_only_difference(jax_ref):
    """Where no accept decision flipped, float32 rows agree to rounding: in
    the base dopri5 case every instance whose step count matches agrees to
    1e-4 (the flipped instances are the ones the looser bound is for)."""
    want, got = jax_ref("base_dopri5", np.float32), _port("base_dopri5", np.float32)
    same = (got["n_steps"] == want["n_steps"]) & (got["n_accepted"] == want["n_accepted"])
    assert same.sum() >= B - 2
    np.testing.assert_allclose(got["ys"][same], want["ys"][same], rtol=0, atol=1e-4)


def test_order_of_convergence():
    """dopri5 and tsit5 converge at order 5 on the harmonic oscillator
    y'' = -y against its closed form (float64, fixed steps, one instance per
    step size).  This does not use reference output: the JAX package's own
    order harness cannot import on this JAX version (ROADMAP C-1)."""
    dts = np.array([0.4, 0.2, 0.1, 0.05])
    y0 = np.tile([1.0, 0.0], (len(dts), 1))
    t_end = 4.0

    def osc(t, y, args):
        return torch.stack((y[:, 1], -y[:, 0]), dim=-1)

    exact = np.array([np.cos(t_end), -np.sin(t_end)])
    for method in ("dopri5", "tsit5"):
        sol = T.solve_ivp(osc, y0, None, t_start=0.0, t_end=t_end, method=method,
                          controller=T.FixedController(), dt0=dts, dense=False, device="cpu")
        assert bool((sol.status == 0).all())
        err = np.abs(sol.ys.numpy() - exact).max(axis=1)
        slopes = np.diff(np.log(err)) / np.diff(np.log(dts))
        assert np.all(np.abs(slopes - 5.0) < 0.4), (method, slopes)
        assert math.isclose(sol.ts.numpy()[0], t_end)
