"""The port's components against the JAX package's, and the port's isolation.

- tableaus, controllers and the term/state plumbing hold the same data and
  decisions as ``repro.core``;
- ``src/repro_torch`` and ``chip_smoke.py`` import neither JAX nor ``repro``,
  and the port runs with JAX blocked;
- no path hides the device: without a card ``solve_ivp`` raises unless the
  caller passes ``device="cpu"``.
"""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch import convert  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("name", sorted(J.TABLEAUS))
def test_tableau_data_matches(name):
    j, t = J.get_tableau(name), T.get_tableau(name)
    for field in ("a", "b_sol", "b_err", "c"):
        jv, tv = getattr(j, field), getattr(t, field)
        if jv is None:
            assert tv is None
        else:
            np.testing.assert_array_equal(tv, jv)
    for field in ("order", "error_order", "fsal", "ssal", "implicit", "stages",
                  "stiffly_accurate"):
        assert getattr(t, field) == getattr(j, field), field
    assert t == T.get_tableau(name) and hash(t) == hash(T.get_tableau(name))


def test_unknown_method_names_the_choices():
    with pytest.raises(ValueError, match="available"):
        T.get_tableau("nope")


@pytest.mark.parametrize("factory", ["integral_controller", "pi_controller", "pid_controller"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_controller_decisions_match(factory, dtype):
    rng = np.random.default_rng(0)
    b = 32
    err = rng.uniform(0, 2.5, b).astype(dtype)
    err[:3] = [0.0, np.inf, 1.0]
    dt = rng.uniform(-1, 1, b).astype(dtype)
    p1, p2 = rng.uniform(0.5, 2, b).astype(dtype), rng.uniform(0.5, 2, b).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        jc = getattr(J, factory)(dt_max=0.8)
        acc, dtn, st = jc(jnp.asarray(err), jnp.asarray(dt), J.PIDController().init(b, dtype)
                          ._replace(prev_inv_ratio=jnp.asarray(p1),
                                    prev2_inv_ratio=jnp.asarray(p2)), 5)
        want = [np.asarray(x) for x in (acc, dtn, *st)]
    tc = getattr(T, factory)(dt_max=0.8)
    assert tc == getattr(T, factory)(dt_max=0.8)
    state = T.ControllerState(torch.tensor(p1), torch.tensor(p2))
    acc, dtn, st = tc(torch.tensor(err), torch.tensor(dt), state, 5)
    np.testing.assert_array_equal(acc.numpy(), want[0])
    tol = 1e-6 if dtype == np.float32 else 1e-12
    for g, w in zip((dtn, *st), want[1:]):
        np.testing.assert_allclose(g.numpy(), w, rtol=tol, atol=tol)


def test_fixed_controller_accepts_and_keeps_dt():
    dt = torch.tensor([0.1, -0.2])
    state = T.FixedController().init(2, torch.float32)
    acc, dtn, st = T.FixedController()(torch.tensor([5.0, np.inf]), dt, state, 1)
    assert bool(acc.all()) and torch.equal(dtn, dt) and st is state


def test_ravel_state_round_trip():
    y = {"b": torch.arange(6.0).reshape(3, 2), "a": (torch.ones(3), torch.zeros(3, 2, 2))}
    flat, rav = T.ravel_state(y)
    assert flat.shape == (3, 2 + 1 + 4) and rav.num_features == 7
    back = rav.unravel(flat)
    torch.testing.assert_close(back["b"], y["b"])
    torch.testing.assert_close(back["a"][1], y["a"][1])
    dense = rav.unravel(flat[:, None, :].expand(3, 5, 7))
    assert dense["a"][1].shape == (3, 5, 2, 2)


def test_ravel_state_flat_inputs():
    for y in (np.ones((2, 3), np.float32), torch.ones(2, 3), [[1.0, 2.0], [3.0, 4.0]]):
        flat, rav = T.ravel_state(y)
        assert rav is None and flat.ndim == 2


def test_unbatched_term_with_batched_args():
    """``batched=False`` + ``batched_args``: each instance sees its own args row."""
    def f(t, y, a):
        return -a * y

    term = T.ODETerm(f, batched=False, batched_args=True)
    y, a = torch.ones(3, 2), torch.tensor([1.0, 2.0, 3.0])
    torch.testing.assert_close(term.vf(torch.zeros(3), y, a), -a[:, None] * y)


def test_convert_round_trip():
    tree = {"w": np.ones((2, 3)), "n": np.arange(3), "s": [np.float64(2.0), 7]}
    out = convert.from_numpy(tree, "cpu", dtype=torch.float32)
    assert out["w"].dtype == torch.float32 and out["n"].dtype == torch.int64
    assert out["s"][0].dtype == torch.float32 and out["s"][1] == 7
    sol = T.solve_ivp(lambda t, y, a: -y, np.ones((2, 3), np.float32), np.linspace(0, 1, 4),
                      device="cpu")
    host = convert.to_numpy(sol)
    assert isinstance(host.ys, np.ndarray) and host.ys.shape == (2, 4, 3)
    assert all(isinstance(v, np.ndarray) for v in host.stats.values())
    np.testing.assert_allclose(host.ys[:, -1], np.exp(-1.0) * np.ones((2, 3)), rtol=1e-3)


def test_windowed_dense_output_matches_full_mask():
    """The windowed write (ROADMAP C-4: no float64 JAX reference) holds the
    same solution as the full-mask write to the solver's tolerance."""
    rng = np.random.default_rng(0)
    y0 = np.array([2.0, 0.0]) + 0.1 * rng.standard_normal((8, 2))

    def vdp(t, y, mu):
        return torch.stack((y[:, 1], mu * (1 - y[:, 0] ** 2) * y[:, 1] - y[:, 0]), dim=-1)

    kw = dict(args=2.0, atol=1e-8, rtol=1e-8, device="cpu")
    te = np.linspace(0, 6.0, 50)
    full = T.solve_ivp(vdp, y0, te, **kw)
    win = T.solve_ivp(vdp, y0, te, dense_window=4, **kw)
    assert torch.equal(win.stats["n_initialized"], full.stats["n_initialized"])
    torch.testing.assert_close(win.ys, full.ys, rtol=0, atol=1e-5)


def test_make_solver_triple_and_max_steps_warning():
    init, step, finish = T.make_solver(lambda t, y, a: -y, rtol=1e-6, atol=1e-8)
    state, consts = init(torch.ones(2, 1, dtype=torch.float64), np.linspace(0, 1, 3))
    while bool(state.running.any()):
        state = step(state, consts, None)
    sol = finish(state, consts)
    np.testing.assert_allclose(sol.ys[:, -1, 0].numpy(), np.exp(-1.0), rtol=1e-6)
    assert int(state.it) == int(sol.stats["n_steps"].max())
    with pytest.warns(UserWarning, match="max_steps"):
        T.make_solver(lambda t, y, a: -y, max_steps=5)


def test_step_on_cpu_leaves_the_old_states_ys():
    """On the CPU ``step`` returns a new dense-output buffer: a state kept
    from before the step keeps its ``ys`` (on the card the buffer is written
    in place; ``tests/test_torch_kernels_card.py`` pins that)."""
    init, step, finish = T.make_solver(lambda t, y, a: -y, rtol=1e-6, atol=1e-8)
    state, consts = init(torch.ones(2, 1, dtype=torch.float64), np.linspace(0, 1, 9))
    wrote = False
    while bool(state.running.any()):
        old, before = state, state.ys.clone()
        state = step(old, consts, None)
        assert state.ys is not old.ys and torch.equal(old.ys, before)
        wrote |= not torch.equal(state.ys, before)
    assert wrote


@pytest.mark.parametrize("make", [
    lambda: T.ExplicitRK("tsit5"),
    lambda: T.AutoDiffAdjoint(T.ExplicitRK("tsit5"), rtol=1e-5),
    lambda: T.StepFunction(lambda t, y, a: -y, "tsit5", rtol=1e-5),
])
def test_config_objects_are_frozen_dataclasses(make):
    obj = make()
    assert dataclasses.is_dataclass(obj)
    with pytest.raises(dataclasses.FrozenInstanceError):
        obj.rtol = 1.0
    with pytest.raises(dataclasses.FrozenInstanceError):
        obj.stepper = None


def test_explicit_rk_compares_by_tableau():
    assert T.ExplicitRK() == T.ExplicitRK("dopri5") == T.ExplicitRK(T.get_tableau("dopri5"))
    assert hash(T.ExplicitRK("dopri5")) == hash(T.ExplicitRK(method=T.get_tableau("dopri5")))
    assert T.ExplicitRK("dopri5") != T.ExplicitRK("tsit5")


class TestNoHiddenDevice:
    def test_solve_without_device_raises_without_a_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.solve_ivp(lambda t, y, a: -y, np.ones((2, 2), np.float32), np.linspace(0, 1, 3))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.AutoDiffAdjoint().solve(lambda t, y, a: -y, np.ones((2, 2)), np.linspace(0, 1, 3))

    @pytest.mark.parametrize("method", sorted(n for n, tab in T.TABLEAUS.items()
                                              if tab.implicit))
    def test_implicit_methods_coerce_to_dirk(self, method):
        """The implicit tableaus are ported: ``coerce`` gives a
        ``DiagonallyImplicitRK`` (it used to refuse, ROADMAP A-10) and a CPU
        solve runs through it."""
        stepper = T.AbstractStepper.coerce(method)
        assert type(stepper) is T.DiagonallyImplicitRK and stepper.tableau.name == method
        sol = T.solve_ivp(lambda t, y, a: -y, np.ones((1, 1)), np.linspace(0, 1, 3),
                          method=method, max_steps=50, device="cpu")
        assert sol.stats["n_newton_iters"].shape == (1,)

    def test_events_must_be_event_objects(self):
        """Events are ported: anything that is not an ``Event`` is refused by
        ``normalize_events``, as in the JAX package."""
        for events, match in ((object(), "not iterable"), ([object()], "expected Event")):
            with pytest.raises(TypeError, match=match):
                T.solve_ivp(lambda t, y, a: -y, np.ones((1, 1)), np.linspace(0, 1, 3),
                            device="cpu", events=events)

    @pytest.mark.parametrize("cls", ["ScanAdjoint", "BacksolveAdjoint"])
    def test_gradient_drivers_keep_the_reference_defaults(self, cls):
        """The gradient drivers are ported: they construct with the JAX
        package's defaults, and their solves raise without a card unless
        given ``device="cpu"``."""
        drv, ref_drv = getattr(T, cls)(), getattr(J, cls)()
        for name in ("max_steps", "rtol", "atol"):
            assert getattr(drv, name) == getattr(ref_drv, name), name
        assert drv.stepper.tableau.name == ref_drv.stepper.tableau.name
        kw = dict(t_start=0.0, t_end=1.0)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.cuda, "is_available", lambda: False)
            with pytest.raises(RuntimeError, match="device='cpu'"):
                drv.solve(lambda t, y, a: -y, np.ones((1, 1)), **kw)
        out = drv.solve(lambda t, y, a: -y, np.ones((1, 1)), device="cpu", **kw)
        y1 = out if cls == "BacksolveAdjoint" else out.ys
        np.testing.assert_allclose(y1.numpy(), np.exp(-1.0) * np.ones((1, 1)), rtol=1e-3)

    def test_inputs_follow_the_device(self):
        sol = T.solve_ivp(lambda t, y, a: -a * y, torch.ones(2, 2, dtype=torch.float64),
                          [0.0, 0.5, 1.0], args=np.float64(2.0), rtol=np.array([1e-6, 1e-5]),
                          device="cpu")
        assert sol.ys.device.type == "cpu" and sol.ts.dtype == torch.float64


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
                         + [ROOT / "chip_smoke.py"], ids=lambda p: p.name)
def test_port_imports_neither_jax_nor_repro(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_port_runs_with_jax_blocked():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import numpy as np
        import repro_torch
        sol = repro_torch.solve_ivp(lambda t, y, a: -y, np.ones((2, 3), np.float32),
                                    np.linspace(0.0, 1.0, 5), device="cpu")
        assert sol.ys.shape == (2, 5, 3) and int(sol.status.max()) == 0
        import torch
        from repro_torch.configs import get_config
        from repro_torch.models import init_params, pad_cache, prefill, decode_step
        cfg = get_config("qwen2.5-14b", reduced=True)
        lm = init_params(cfg, 0, "cpu")
        tok = torch.randint(0, cfg.vocab, (2, 9))
        logits, cache = prefill(cfg, lm, {"tokens": tok})
        cache = pad_cache(cfg, cache, 10)
        logits, cache = decode_step(cfg, lm, tok[:, 0], torch.full((2,), 9), cache)
        assert logits.shape == (2, cfg.vocab) and bool(torch.isfinite(logits).all())
        assert not any(m.split(".")[0] in ("jax", "repro") for m in sys.modules
                       if sys.modules[m] is not None)
        print("ok")
    """)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_public_names_exported():
    for name in T.__all__:
        assert getattr(repro_torch, name) is getattr(T, name)
