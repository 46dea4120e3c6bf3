"""The port's compiled front end (``repro_torch.core.compiled``, ``static``,
``graphs``) on the CPU, mirroring ``tests/test_compiled.py``'s classes.

Covers: the static config (components hash by value and are frozen, the
drivers' ``static_key``, ``leaf_key``/``tree_key``); the cache (one entry for
repeated same-shape solves, a new one on a shape, dtype, static-config or
device change, tolerances dynamic); ``compile``/``prewarm``; donation; the
block runner bitwise against the eager driver for k = 1, 3 and 16 (on the CPU
the captured blocks run without a graph); the port against the JAX package's
``CompiledSolver`` and ``sharded_solve``; gradient entries (``cotangent=``);
uncaptured entries (events, an implicit stepper) and their reasons.

Inputs are made with numpy from a seed.  Tolerances: float64 against the JAX
package, equal step counts and ``ys`` within 1e-9 (gradients 1e-9 relative);
float32 within the solver's own global error (ROADMAP C-5: XLA's and ATen's
float32 ``pow`` differ by an ulp on ~1 % of inputs, which can flip a step
decision); the port against itself bitwise.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import compiled as TC  # noqa: E402
from repro_torch.core.static import (  # noqa: E402
    Spec,
    freeze,
    frozen_setattr,
    leaf_key,
    tree_key,
    value_eq,
)

B, MU = 12, 2.0
T_END = float((3.0 - 2.0 * np.log(2.0)) * MU + 2 * np.pi / MU ** (1 / 3))
COUNTS = ("n_steps", "n_accepted", "n_f_evals", "n_initialized")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def vdp(t, y, mu):
    x, v = y[..., 0], y[..., 1]
    return torch.stack((v, mu * (1 - x**2) * v - x), dim=-1)


def vdp_jax(t, y, mu):
    x, v = y[..., 0], y[..., 1]
    return jnp.stack((v, mu * (1 - x**2) * v - x), axis=-1)


def decay(t, y, args):
    return -y if args is None else -y * args


def decay_jax(t, y, args):
    return -y if args is None else -y * args


def mlp(t, y, p):
    return torch.tanh(y @ p["w1"] + p["b1"]) @ p["w2"]


def vdp_dict(t, y, mu):
    return {"x": y["v"], "v": mu * (1 - y["x"] ** 2) * y["v"] - y["x"]}


def _y0(dtype=np.float64, b=B, seed=0):
    rng = np.random.default_rng(seed)
    return (np.array([2.0, 0.0]) + 0.1 * rng.standard_normal((b, 2))).astype(dtype)


def _te(dtype=np.float64, n=40, end=T_END):
    return np.linspace(0.0, end, n).astype(dtype)


def _mlp_args(f=6, h=8, dtype=np.float64):
    rng = np.random.default_rng(3)
    return {"w1": rng.standard_normal((f, h)) / np.sqrt(f), "b1": rng.standard_normal(h) * 0.1,
            "w2": rng.standard_normal((h, f)) / np.sqrt(h)}


def _t(x):
    return convert.from_numpy(x, "cpu")


def _bitwise(a, b, name):
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True, msg=name)


def _same(got, want, skip=()):
    """Every field of two solutions bitwise equal (NaN where NaN), but the
    stats named in ``skip``."""
    for name in ("ts", "status", "event_t", "event_mask"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            _bitwise(a, b, name)
    ya, yb = torch.utils._pytree.tree_leaves(got.ys), torch.utils._pytree.tree_leaves(want.ys)
    assert len(ya) == len(yb), "ys"
    for a, b in zip(ya, yb):
        _bitwise(a, b, "ys")
    assert set(got.stats) == set(want.stats)
    for k in set(want.stats) - set(skip):
        _bitwise(got.stats[k], want.stats[k], k)


# ---------------------------------------------------------------------------
# Static config.


class TestStaticConfig:
    def test_components_hash_by_value(self):
        assert T.ExplicitRK("tsit5") == T.ExplicitRK("tsit5")
        assert hash(T.ExplicitRK("tsit5")) == hash(T.ExplicitRK("tsit5"))
        assert T.ExplicitRK("tsit5") != T.ExplicitRK("dopri5")
        assert T.DiagonallyImplicitRK("kvaerno3") == T.DiagonallyImplicitRK("kvaerno3")
        assert hash(T.DiagonallyImplicitRK("kvaerno3")) == hash(T.DiagonallyImplicitRK("kvaerno3"))
        assert T.DiagonallyImplicitRK(
            "kvaerno3", newton=T.NewtonConfig(tol=1e-5)) != T.DiagonallyImplicitRK("kvaerno3")
        assert T.get_tableau("dopri5") == T.get_tableau("dopri5")
        assert hash(T.get_tableau("dopri5")) != hash(T.get_tableau("tsit5"))
        assert T.pid_controller() == T.pid_controller()
        assert hash(T.pid_controller()) == hash(T.pid_controller())
        assert T.pid_controller() != T.integral_controller()
        assert T.FixedController() == T.FixedController()
        assert hash(T.ODETerm(decay)) == hash(T.ODETerm(decay))
        assert T.ODETerm(decay) != T.ODETerm(vdp)
        assert hash(T.Event(decay)) == hash(T.Event(decay))

    def test_components_frozen(self):
        for obj in (T.ExplicitRK("tsit5"), T.DiagonallyImplicitRK("kvaerno3"),
                    T.AutoDiffAdjoint(T.Stepper("dopri5")), T.ScanAdjoint(),
                    T.BacksolveAdjoint(), T.StepFunction(decay), T.CompiledSolver(),
                    T.pid_controller(), T.Event(decay), T.ODETerm(decay)):
            with pytest.raises(AttributeError):
                obj.anything = 1
        with pytest.raises(ValueError):
            T.get_tableau("dopri5").a[0, 0] = 99.0  # coefficient arrays are read-only

    def test_driver_static_key_excludes_tolerances(self):
        a = T.AutoDiffAdjoint(T.Stepper("tsit5"), T.pid_controller(),
                              rtol=torch.full((4,), 1e-5), atol=1e-8)
        b = T.AutoDiffAdjoint(T.Stepper("tsit5"), T.pid_controller(), rtol=0.1, atol=1e-3)
        assert a.static_key() == b.static_key()
        assert hash(a.static_key()) == hash(b.static_key())
        names = [n for n, _ in a.static_key()[1]]
        assert "rtol" not in names and "atol" not in names and "max_steps" in names
        for other in (T.AutoDiffAdjoint(T.Stepper("dopri5"), T.pid_controller()),
                      T.AutoDiffAdjoint(T.Stepper("tsit5"), T.pid_controller(), max_steps=5),
                      T.AutoDiffAdjoint(T.Stepper("tsit5"), T.pid_controller(), fused=True),
                      T.AutoDiffAdjoint(T.Stepper("tsit5"), T.pid_controller(), dense_window=2),
                      T.ScanAdjoint(T.Stepper("tsit5"), T.pid_controller())):
            assert other.static_key() != a.static_key()

    def test_backsolve_static_key_skips_memo(self):
        a = T.BacksolveAdjoint("dopri5", rtol=1e-7)
        a.solve(decay, np.ones((2, 3)), t_start=0.0, t_end=1.0, args=1.0, device="cpu")
        assert a._solve_memo  # filled by the solve, and not part of the key
        b = T.BacksolveAdjoint("dopri5", rtol=1e-3)
        assert a.static_key() == b.static_key() and hash(a.static_key())
        assert T.BacksolveAdjoint("dopri5", mode="per_instance").static_key() != b.static_key()

    def test_leaf_key(self):
        x = torch.zeros((3, 2), dtype=torch.float32)
        assert leaf_key(x) == ((3, 2), torch.float32, torch.device("cpu"))
        assert leaf_key(x) == leaf_key(torch.ones((3, 2)))
        assert leaf_key(x) != leaf_key(x.double())
        assert leaf_key(Spec((3, 2), torch.float32, torch.device("cpu"))) == leaf_key(x)
        assert leaf_key(1.5) == leaf_key(2.5) == "float"
        assert leaf_key(1) == "int" and leaf_key(True) == "bool"
        assert leaf_key(None) is None and leaf_key({"a": x}) is None

    def test_tree_key(self):
        a = {"w": torch.ones((2, 3)), "b": (1.0, torch.zeros(3))}
        b = {"w": torch.zeros((2, 3)), "b": (7.0, torch.ones(3))}
        assert tree_key(a) == tree_key(b) and hash(tree_key(a)) == hash(tree_key(b))
        assert tree_key(a) != tree_key({"w": torch.ones((2, 4)), "b": (1.0, torch.zeros(3))})
        assert tree_key(a) != tree_key({"w": torch.ones((2, 3)), "b": (1, torch.zeros(3))})
        assert tree_key(a) != tree_key({"v": torch.ones((2, 3)), "b": (1.0, torch.zeros(3))})
        spec = {"w": Spec((2, 3), torch.float32, torch.device("cpu")),
                "b": (1.0, Spec((3,), torch.float32, torch.device("cpu")))}
        assert tree_key(spec) == tree_key(a)
        assert tree_key(None) is None

    def test_value_eq_and_freeze(self):
        @value_eq
        class Cfg:
            __setattr__ = frozen_setattr

            def __init__(self, a, b):
                self.a, self.b = a, b
                freeze(self)

        assert Cfg(1, (2, 3)) == Cfg(1, (2, 3)) and hash(Cfg(1, 2)) == hash(Cfg(1, 2))
        assert Cfg(1, 2) != Cfg(1, 3)
        with pytest.raises(AttributeError, match="frozen"):
            Cfg(1, 2).a = 5

    def test_backsolve_final_state_only(self):
        solver = T.CompiledSolver(T.BacksolveAdjoint(T.Stepper("dopri5"), rtol=1e-7,
                                                     atol=1e-9), donate=False)
        y0 = torch.ones((2, 3), dtype=torch.float64)
        with pytest.raises(TypeError, match="final state"):
            solver.solve(decay, y0, np.linspace(0.0, 1.0, 4), args=1.0, device="cpu")
        with pytest.raises(TypeError, match="final state"):
            solver.solve(decay, y0, None, t_start=0.0, t_end=1.0, args=1.0, dt0=0.01,
                         device="cpu")
        sol = solver.solve(decay, y0, None, t_start=0.0, t_end=1.0, args=1.0, device="cpu")
        np.testing.assert_allclose(sol.ys.numpy(), np.exp(-1.0) * np.ones((2, 3)), atol=1e-6)
        assert torch.all(sol.status == T.Status.SUCCESS.value)
        assert torch.equal(sol.ts, torch.ones(2, dtype=torch.float64))


# ---------------------------------------------------------------------------
# The cache: one entry per program point.


class TestZeroRecapture:
    def test_one_entry_for_repeated_same_shape_solves(self):
        solver = T.CompiledSolver(T.AutoDiffAdjoint(T.Stepper("dopri5")), donate=False)
        te = _te(np.float32, 6, 1.0)
        first = solver.compile(decay, np.ones((8, 3), np.float32), te, args=1.0, device="cpu")
        sols = [solver.solve(decay, np.full((8, 3), 0.5 + i, np.float32), te, args=0.5 + i,
                             device="cpu") for i in range(5)]
        info = solver.cache_info()
        assert (info.misses, info.hits, info.currsize) == (1, 5, 1)
        assert first.runner is not None and first.runner.replays > 0
        np.testing.assert_allclose(sols[1].ys[:, -1].numpy(), np.exp(-1.5) * 1.5, rtol=2e-3)

    def test_new_entry_on_shape_dtype_static_or_device_change(self):
        solver = T.CompiledSolver(T.AutoDiffAdjoint(T.Stepper("dopri5")), donate=False)
        te = _te(np.float32, 6, 1.0)
        y8, y4 = np.ones((8, 3), np.float32), np.ones((4, 3), np.float32)
        a = torch.tensor(1.0)
        solver.solve(decay, y8, te, args=a, device="cpu")
        solver.solve(decay, y4, te, args=a, device="cpu")  # batch shape
        assert solver.cache_info().misses == 2
        solver.solve(decay, y4, te, args=torch.tensor(1, dtype=torch.int32), device="cpu")
        assert solver.cache_info().misses == 3  # dtype of a dynamic argument
        solver.solve(decay, y4, _te(np.float32, 9, 1.0), args=a, device="cpu")
        assert solver.cache_info().misses == 4  # t_eval length
        solver.solve(decay, y4.astype(np.float64), te.astype(np.float64), args=a, device="cpu")
        assert solver.cache_info().misses == 5  # state dtype
        # Back to seen points: no new entry.
        solver.solve(decay, y8, te, args=a, device="cpu")
        solver.solve(decay, y4, te, args=a, device="cpu")
        assert solver.cache_info().misses == 5 and solver.cache_info().hits == 2
        # Static config: another tableau is another solver's entry and key.
        other = T.CompiledSolver(T.AutoDiffAdjoint(T.Stepper("tsit5")), donate=False)
        assert other.cache_key(decay, y8, te, args=a, device="cpu") != solver.cache_key(
            decay, y8, te, args=a, device="cpu")
        # Device: each device keys its own entry.
        spec = Spec((8, 3), torch.float32)
        assert solver.cache_key(decay, spec, te, args=a, device="cpu") != solver.cache_key(
            decay, spec, te, args=a, device="meta")
        # The vector field by identity: another callable, another entry.
        solver.solve(lambda t, y, k: -y * k, y8, te, args=a, device="cpu")
        assert solver.cache_info().misses == 6

    @pytest.mark.parametrize("fused", [False, True])
    def test_tolerances_are_dynamic(self, fused):
        """Two tolerance values through one entry, each equal to the eager
        solve at that tolerance, bitwise."""
        drv = T.AutoDiffAdjoint(T.Stepper("dopri5"), rtol=1e-3, atol=1e-6, fused=fused)
        solver = T.CompiledSolver(drv, donate=False)
        y0, te = _y0(np.float32), _te(np.float32)
        loose = solver.solve(vdp, y0, te, args=MU, device="cpu")
        tight = solver.solve(vdp, y0, te, args=MU, rtol=1e-7, atol=1e-9, device="cpu")
        assert solver.cache_info().misses == 1 and solver.cache_info().hits == 1
        _same(loose, drv.solve(vdp, y0, te, args=MU, device="cpu"))
        _same(tight, dataclasses.replace(drv, rtol=1e-7, atol=1e-9).solve(
            vdp, y0, te, args=MU, device="cpu"))
        assert torch.all(tight.stats["n_steps"] > loose.stats["n_steps"])

    def test_per_instance_tolerance_builds_one_more_entry(self):
        drv = T.AutoDiffAdjoint(T.Stepper("dopri5"), rtol=1e-5, atol=1e-7)
        solver = T.CompiledSolver(drv, donate=False)
        y0, te = _y0(), _te()
        solver.solve(vdp, y0, te, args=MU, device="cpu")
        rows = np.where(np.arange(B) % 2 == 0, 1e-7, 1e-4)
        for scale in (1.0, 10.0):
            got = solver.solve(vdp, y0, te, args=MU, rtol=rows * scale, device="cpu")
            _same(got, dataclasses.replace(drv, rtol=rows * scale).solve(
                vdp, y0, te, args=MU, device="cpu"))
        assert solver.cache_info().misses == 2 and solver.cache_info().hits == 1

    def test_evicted_entry_frees_its_buffers(self):
        """The cache is bounded by entries; an entry it drops frees its
        runner's buffers at once, and a handle still held builds anew."""
        import weakref

        solver = T.CompiledSolver(T.AutoDiffAdjoint(T.Stepper("dopri5")), donate=False,
                                  cache_size=1)
        te = _te(np.float32, 6, 1.0)
        y8, y4 = np.ones((8, 3), np.float32), np.ones((4, 3), np.float32)
        handle = solver.compile(decay, y8, te, args=1.0, device="cpu")
        runner = handle.runner
        assert runner.buffer_bytes >= runner.state.ys.nbytes > 0
        buffer = weakref.ref(runner.state.ys)
        solver.solve(decay, y4, te, args=1.0, device="cpu")
        assert solver.cache_info().currsize == 1 and handle.runner is None
        assert buffer() is None and runner.state is None
        want = T.AutoDiffAdjoint(T.Stepper("dopri5")).solve(decay, y8, te, args=1.0,
                                                             device="cpu")
        _same(handle(y8, te, args=1.0), want)
        assert handle.runner is not None and solver.cache_info().currsize == 1
        solver.cache_clear()
        assert solver.cache_info().currsize == 0

    def test_dropped_solver_frees_entries_without_the_collector(self):
        """No entry refers back to its solver, so dropping the solver frees
        its entries by reference count alone (on the card: never later, in
        the middle of another capture)."""
        import gc
        import weakref

        solver = T.CompiledSolver(T.AutoDiffAdjoint(T.Stepper("dopri5")), donate=False)
        handle = solver.compile(decay, np.ones((8, 3), np.float32), _te(np.float32, 6, 1.0),
                                args=1.0, device="cpu")
        refs = [weakref.ref(solver), weakref.ref(handle.runner)]
        collecting = gc.isenabled()
        gc.disable()
        try:
            del solver, handle
            assert [r() for r in refs] == [None, None]
        finally:
            if collecting:
                gc.enable()

    def test_args_numbers_are_dynamic(self):
        """A Python number in args keys by type: a new value reuses the entry
        and is read from its buffer, not baked in."""
        solver = T.CompiledSolver(T.AutoDiffAdjoint(T.Stepper("tsit5"), rtol=1e-6), k=4)
        y0, te = _y0(), _te()
        for mu in (1.0, 3.0):
            _same(solver.solve(vdp, y0, te, args=mu, device="cpu"),
                  T.AutoDiffAdjoint(T.Stepper("tsit5"), rtol=1e-6).solve(
                      vdp, y0, te, args=mu, device="cpu"))
        assert solver.cache_info().misses == 1


class TestCompilePrewarm:
    def _specs(self):
        return dict(y0=Spec((8, 3), torch.float32), t_eval=None,
                    t_start=Spec((), torch.float32), t_end=Spec((), torch.float32),
                    args=Spec((), torch.float32))

    def test_compile_then_solve_hits(self):
        solver = T.CompiledSolver(T.AutoDiffAdjoint(T.Stepper("dopri5")), donate=False)
        sp = self._specs()
        handle = solver.compile(decay, sp["y0"], None, t_start=sp["t_start"],
                                t_end=sp["t_end"], args=sp["args"], device="cpu")
        assert handle.captured and handle.why is None and handle.runner is not None
        assert handle.runner.replays == 0  # built from stand-ins, not run
        t0, t1, a = torch.tensor(0.0), torch.tensor(1.0), torch.tensor(1.0)
        out = handle(torch.ones((8, 3)), None, t_start=t0, t_end=t1, args=a)
        sol = solver.solve(decay, torch.ones((8, 3)), None, t_start=t0, t_end=t1, args=a,
                           device="cpu")
        assert solver.cache_info().misses == 1 and solver.cache_info().hits == 1
        assert torch.equal(out.ys, sol.ys) and out.ys.shape == (8, 3)
        np.testing.assert_allclose(sol.ys.numpy(), np.exp(-1.0), rtol=2e-3)
        assert "blocks of 16 steps" in handle.as_text()
        with pytest.raises(ValueError, match="differ"):
            handle(torch.ones((4, 3)), None, t_start=t0, t_end=t1, args=a)

    def test_meta_tensor_specs(self):
        solver = T.CompiledSolver(T.AutoDiffAdjoint(T.Stepper("dopri5")), donate=False)
        meta = torch.empty((8, 3), device="meta")
        handle = solver.compile(decay, meta, torch.empty(5, device="meta"), args=1.0,
                                device="cpu")
        sol = handle(torch.ones((8, 3)), torch.linspace(0, 1, 5), args=1.0)
        assert sol.ys.shape == (8, 5, 3) and solver.cache_info().misses == 1

    def test_prewarm_is_idempotent(self):
        solver = T.CompiledSolver(T.AutoDiffAdjoint(T.Stepper("dopri5")), donate=False)
        specs = [dict(self._specs(), device="cpu"),
                 dict(self._specs(), y0=Spec((4, 3), torch.float32), device="cpu"),
                 dict(self._specs(), rtol=Spec((8,), torch.float32), device="cpu")]
        assert solver.prewarm(decay, specs) == 3
        assert solver.prewarm(decay, specs) == 0
        assert solver.cache_info().currsize == 3
        with pytest.raises(TypeError, match="unknown prewarm spec keys"):
            solver.prewarm(decay, [dict(self._specs(), bogus=1)])


class TestDonation:
    def test_final_state_solve_donates_y0(self):
        solver = T.CompiledSolver(T.AutoDiffAdjoint(T.Stepper("dopri5")))
        y0 = torch.ones((8, 3))
        want = T.AutoDiffAdjoint(T.Stepper("dopri5")).solve(
            decay, y0.clone(), None, t_start=0.0, t_end=1.0, args=1.0, device="cpu")
        sol = solver.solve(decay, y0, None, t_start=0.0, t_end=1.0, args=1.0, device="cpu")
        assert sol.ys.data_ptr() == y0.data_ptr() and sol.ys is y0
        assert torch.equal(y0, want.ys)

    def test_dense_solve_does_not_donate(self):
        solver = T.CompiledSolver(T.AutoDiffAdjoint(T.Stepper("dopri5")))
        y0 = torch.ones((8, 3))
        sol = solver.solve(decay, y0, np.linspace(0.0, 1.0, 5), args=1.0, device="cpu")
        assert torch.equal(y0, torch.ones((8, 3))) and sol.ys.data_ptr() != y0.data_ptr()

    def test_donate_false_keeps_buffers(self):
        solver = T.CompiledSolver(T.AutoDiffAdjoint(T.Stepper("dopri5")), donate=False)
        y0 = torch.ones((8, 3))
        sol = solver.solve(decay, y0, None, t_start=0.0, t_end=1.0, args=1.0, device="cpu")
        assert torch.equal(y0, torch.ones((8, 3))) and sol.ys.data_ptr() != y0.data_ptr()

    def test_numpy_y0_cannot_be_donated(self):
        solver = T.CompiledSolver(T.AutoDiffAdjoint(T.Stepper("dopri5")))
        y0 = np.ones((8, 3), np.float32)
        sol = solver.solve(decay, y0, None, t_start=0.0, t_end=1.0, args=1.0, device="cpu")
        assert np.all(y0 == 1.0) and sol.ys.shape == (8, 3)

    def test_result_does_not_alias_buffers(self):
        """A returned solution survives the next solve through its entry."""
        solver = T.CompiledSolver(T.AutoDiffAdjoint(T.Stepper("dopri5")), donate=False)
        te = _te(n=10)
        first = solver.solve(vdp, _y0(), te, args=MU, device="cpu")
        kept = convert.to_numpy(first)
        solver.solve(vdp, _y0(seed=5), te, args=3.0, device="cpu")
        np.testing.assert_array_equal(first.ys.numpy(), kept.ys)
        np.testing.assert_array_equal(first.stats["n_steps"].numpy(), kept.stats["n_steps"])


# ---------------------------------------------------------------------------
# The block runner against the eager driver, bitwise.


def _cases():
    y64, te64 = _y0(), _te()
    y32, te32 = _y0(np.float32), _te(np.float32)
    rows = np.where(np.arange(B) % 3 == 0, 1e-8, 1e-4)
    dict_y0 = {"x": y64[:, :1], "v": y64[:, 1:]}
    return {
        "dopri5-dense-f64": (T.AutoDiffAdjoint("dopri5", rtol=1e-6, atol=1e-8), vdp, y64,
                             te64, {}),
        "dopri5-dense-f32": (T.AutoDiffAdjoint("dopri5", rtol=1e-5, atol=1e-5), vdp, y32,
                             te32, {}),
        "tsit5-final-state": (T.AutoDiffAdjoint("tsit5", rtol=1e-6), vdp, y64, None,
                              dict(t_start=0.0, t_end=T_END)),
        "dopri5-fused": (T.AutoDiffAdjoint("dopri5", rtol=1e-6, fused=True), vdp, y64,
                         te64, {}),
        "tsit5-fused-f32": (T.AutoDiffAdjoint("tsit5", rtol=1e-5, atol=1e-5, fused=True), vdp,
                            y32, te32, {}),
        "dense-window": (T.AutoDiffAdjoint("dopri5", rtol=1e-6, dense_window=3), vdp, y64,
                         te64, {}),
        "structured-state": (T.AutoDiffAdjoint("dopri5", rtol=1e-6), vdp_dict, dict_y0,
                             te64, {}),
        "per-instance-tol": (T.AutoDiffAdjoint("dopri5", rtol=rows, atol=rows * 1e-2), vdp,
                             y64, te64, {}),
        "max-steps-reached": (T.AutoDiffAdjoint("dopri5", rtol=1e-8, max_steps=23), vdp,
                              y64, te64, {}),
        "pid-dt0": (T.AutoDiffAdjoint("bosh3", T.pid_controller(), rtol=1e-5), vdp, y64,
                    te64, dict(dt0=0.01)),
        "mlp-args": (T.AutoDiffAdjoint("dopri5", rtol=1e-6), mlp,
                     np.random.default_rng(1).standard_normal((B, 6)), _te(n=9, end=2.0),
                     dict(args=_mlp_args())),
        "scan-forward": (T.ScanAdjoint("dopri5", rtol=1e-6, max_steps=37), vdp, y64, te64,
                         {}),
    }


CASES = _cases()


@pytest.mark.parametrize("k", [1, 3, 16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_block_runner_matches_eager_bitwise(case, k):
    drv, vf, y0, te, kw = CASES[case]
    kw = dict(kw)
    args = kw.pop("args", MU)
    if isinstance(args, dict):
        args = _t(args)
    solver = T.CompiledSolver(drv, k=k, donate=False)
    eager = drv.solve(vf, y0, te, args=args, device="cpu", **kw)
    for _ in range(2):  # the second call replays the entry the first built
        got = solver.solve(vf, y0, te, args=args, device="cpu", **kw)
        _same(got, eager)
    runner = solver.compile(vf, y0, te, args=args, device="cpu", **kw).runner
    bounded = isinstance(drv, T.ScanAdjoint)
    iters = drv.max_steps if bounded else int(eager.stats["n_steps"].max())
    blocks = -(-iters // k)
    assert runner.replays == 2 * blocks
    assert runner.reads == (0 if bounded else 2 * blocks)
    assert runner.captures == 0  # no graph on the CPU
    if case == "max-steps-reached":
        assert drv.max_steps % k or k == 1
        assert torch.any(got.status == T.Status.REACHED_MAX_STEPS.value)
        assert int(got.stats["n_steps"].max()) == drv.max_steps


def test_refuses_inputs_that_require_grad():
    solver = T.CompiledSolver(T.AutoDiffAdjoint("dopri5"))
    y0 = torch.ones((4, 2), requires_grad=True)
    with pytest.raises(TypeError, match="cotangent="):
        solver.solve(decay, y0, None, t_start=0.0, t_end=1.0, args=1.0, device="cpu")
    with pytest.raises(TypeError, match="cotangent="):
        solver.solve(decay, y0.detach(), None, t_start=0.0, t_end=1.0,
                     args=torch.tensor(1.0, requires_grad=True), device="cpu")
    with torch.no_grad():
        solver.solve(decay, y0, None, t_start=0.0, t_end=1.0, args=1.0, device="cpu")


def test_k_must_be_positive():
    with pytest.raises(ValueError, match="k must be"):
        T.CompiledSolver(k=0)
    with pytest.raises(TypeError, match="to the driver"):
        T.CompiledSolver(T.AutoDiffAdjoint(), rtol=1e-3)


# ---------------------------------------------------------------------------
# Uncaptured entries.


class TestUncapturedEntries:
    @pytest.mark.parametrize("kind", ["events", "implicit", "implicit-fused", "backsolve"])
    def test_why_and_equal_to_eager(self, kind):
        y0, te = _y0(), _te(n=12, end=3.0)
        kw = dict(args=MU)
        if kind == "events":
            ev = T.Event(lambda t, y, a: y[0] - 0.5, terminal=True, direction=-1.0)
            drv = T.AutoDiffAdjoint("dopri5", rtol=1e-6, events=ev)
            why = "newly.any()"
        elif kind.startswith("implicit"):
            drv = T.AutoDiffAdjoint(T.DiagonallyImplicitRK("kvaerno3"), rtol=1e-5,
                                    fused=kind.endswith("fused"))
            why = "active.any()"
        else:
            drv = T.BacksolveAdjoint("dopri5", rtol=1e-7)
            te, kw = None, dict(args=MU, t_start=0.0, t_end=1.0)
            why = "BacksolveAdjoint"
        solver = T.CompiledSolver(drv, donate=False)
        handle = solver.compile(vdp, y0, te, device="cpu", **kw)
        assert not handle.captured and why in handle.why and handle.runner is None
        assert "not captured" in handle.as_text()
        got = handle(y0, te, **kw)
        if kind == "backsolve":
            want = drv.solve(vdp, y0, device="cpu", **kw)
            assert torch.equal(got.ys, want)
        else:
            _same(got, drv.solve(vdp, y0, te, device="cpu", **kw))
            if kind == "events":
                assert torch.any(got.status == T.Status.EVENT.value)
        assert solver.cache_info().misses == 1


# ---------------------------------------------------------------------------
# Against the JAX package's CompiledSolver.


@pytest.mark.parametrize("method,fused", [("dopri5", False), ("tsit5", False),
                                          ("dopri5", True)])
def test_against_jax_compiled_float64(method, fused):
    y0, te = _y0(), _te()
    with jax.enable_x64(True):
        jsol = J.CompiledSolver(J.AutoDiffAdjoint(J.Stepper(method), rtol=1e-7, atol=1e-9,
                                                  fused=fused),
                                donate=False).solve(vdp_jax, jnp.asarray(y0), jnp.asarray(te),
                                                    args=MU)
        jys = np.asarray(jsol.ys)
        jstats = {k: np.asarray(jsol.stats[k]) for k in COUNTS}
        jstatus = np.asarray(jsol.status)
    sol = T.CompiledSolver(T.AutoDiffAdjoint(T.Stepper(method), rtol=1e-7, atol=1e-9,
                                             fused=fused), donate=False, k=5).solve(
        vdp, y0, te, args=MU, device="cpu")
    for k in ("n_steps", "n_accepted"):
        np.testing.assert_array_equal(sol.stats[k].numpy(), jstats[k], err_msg=k)
    np.testing.assert_array_equal(sol.status.numpy(), jstatus)
    np.testing.assert_allclose(sol.ys.numpy(), jys, rtol=1e-9, atol=1e-9)


def test_against_jax_compiled_final_state_float64():
    y0 = _y0()
    with jax.enable_x64(True):
        jsol = J.CompiledSolver(J.AutoDiffAdjoint(J.Stepper("tsit5"), rtol=1e-8, atol=1e-10),
                                donate=False).solve(vdp_jax, jnp.asarray(y0), None,
                                                    t_start=0.0, t_end=T_END, args=MU)
        jys, jsteps = np.asarray(jsol.ys), np.asarray(jsol.stats["n_steps"])
    sol = T.CompiledSolver(T.AutoDiffAdjoint(T.Stepper("tsit5"), rtol=1e-8, atol=1e-10)).solve(
        vdp, torch.as_tensor(y0), None, t_start=0.0, t_end=T_END, args=MU, device="cpu")
    np.testing.assert_array_equal(sol.stats["n_steps"].numpy(), jsteps)
    np.testing.assert_allclose(sol.ys.numpy(), jys, rtol=1e-9, atol=1e-9)


def test_against_jax_compiled_float32_within_global_error():
    """float32: within the solver's own global error (C-5), equal status."""
    y0, te = _y0(np.float32), _te(np.float32)
    jsol = J.CompiledSolver(J.AutoDiffAdjoint(J.Stepper("dopri5"), rtol=1e-5, atol=1e-5),
                            donate=False).solve(vdp_jax, jnp.asarray(y0), jnp.asarray(te),
                                                args=MU)
    sol = T.CompiledSolver(T.AutoDiffAdjoint(T.Stepper("dopri5"), rtol=1e-5,
                                             atol=1e-5)).solve(vdp, y0, te, args=MU,
                                                               device="cpu")
    truth = T.solve_ivp(vdp, y0.astype(np.float64), te.astype(np.float64), args=MU,
                        rtol=1e-10, atol=1e-10, device="cpu")
    global_err = float(np.abs(np.asarray(jsol.ys) - truth.ys.numpy()).max())
    d = float(np.abs(sol.ys.numpy() - np.asarray(jsol.ys)).max())
    assert d <= max(1e-4, global_err)
    np.testing.assert_array_equal(sol.status.numpy(), np.asarray(jsol.status))
    steps, jsteps = sol.stats["n_steps"].numpy(), np.asarray(jsol.stats["n_steps"])
    assert np.all(np.abs(steps.astype(int) - jsteps) <= np.ceil(0.1 * jsteps))


# ---------------------------------------------------------------------------
# Gradient entries.


def _rel_close(got, want, rtol=1e-9):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(want).max())))


class TestGradientEntries:
    @pytest.mark.parametrize("driver", ["scan", "backsolve"])
    def test_against_autograd_of_the_eager_solve(self, driver):
        y0 = torch.as_tensor(_y0())
        mu = torch.tensor(MU, dtype=torch.float64)
        ct = torch.as_tensor(np.random.default_rng(7).standard_normal((B, 2)))
        if driver == "scan":
            drv = T.ScanAdjoint("dopri5", rtol=1e-7, atol=1e-9, max_steps=80)
        else:
            drv = T.BacksolveAdjoint("dopri5", rtol=1e-9, atol=1e-10)
        solver = T.CompiledSolver(drv)
        handle = solver.compile(vdp, y0, None, t_start=0.0, t_end=1.5, args=mu, cotangent=ct,
                                device="cpu")
        assert not handle.captured and "gradient entry" in handle.why
        sol = solver.solve(vdp, y0, None, t_start=0.0, t_end=1.5, args=mu, cotangent=ct,
                           device="cpu")
        assert solver.cache_info().misses == 1 and torch.equal(y0, torch.as_tensor(_y0()))
        y_req, mu_req = y0.clone().requires_grad_(), mu.clone().requires_grad_()
        if driver == "backsolve":
            ys = drv.solve(vdp, y_req, t_start=0.0, t_end=1.5, args=mu_req, device="cpu")
        else:
            ys = drv.solve(vdp, y_req, None, t_start=0.0, t_end=1.5, args=mu_req,
                           device="cpu").ys
        g_y0, g_mu = torch.autograd.grad(ys, (y_req, mu_req), ct)
        assert torch.equal(sol.ys, ys.detach())
        assert torch.equal(sol.grads.y0, g_y0) and torch.equal(sol.grads.args, g_mu)
        assert not sol.ys.requires_grad and not sol.grads.y0.requires_grad

    @pytest.mark.parametrize("driver", ["scan", "backsolve"])
    def test_against_jax_gradient_program_float64(self, driver):
        y0 = _y0()
        args = _mlp_args(f=2, h=5)
        ct = np.random.default_rng(8).standard_normal((B, 2))

        def mlp_jax(t, y, p):
            return jnp.tanh(y @ p["w1"] + p["b1"]) @ p["w2"]

        with jax.enable_x64(True):
            if driver == "scan":
                jdrv = J.ScanAdjoint(J.Stepper("dopri5"), rtol=1e-8, atol=1e-10, max_steps=60)
            else:
                jdrv = J.BacksolveAdjoint(J.Stepper("dopri5"), rtol=1e-10, atol=1e-12)
            jsol = J.CompiledSolver(jdrv).solve(
                mlp_jax, jnp.asarray(y0), None, t_start=0.0, t_end=1.0,
                args={k: jnp.asarray(v) for k, v in args.items()}, cotangent=jnp.asarray(ct))
            jys = np.asarray(jsol.ys)
            jgy = np.asarray(jsol.grads.y0)
            jga = {k: np.asarray(v) for k, v in jsol.grads.args.items()}
            jsteps = None if driver == "backsolve" else np.asarray(jsol.stats["n_steps"])
        if driver == "scan":
            drv = T.ScanAdjoint("dopri5", rtol=1e-8, atol=1e-10, max_steps=60)
        else:
            drv = T.BacksolveAdjoint("dopri5", rtol=1e-10, atol=1e-12)
        sol = T.CompiledSolver(drv).solve(mlp, y0, None, t_start=0.0, t_end=1.0,
                                          args=_t(args), cotangent=torch.as_tensor(ct),
                                          device="cpu")
        if jsteps is not None:
            np.testing.assert_array_equal(sol.stats["n_steps"].numpy(), jsteps)
        _rel_close(sol.ys.numpy(), jys)
        _rel_close(sol.grads.y0.numpy(), jgy)
        for k in args:
            _rel_close(sol.grads.args[k].numpy(), jga[k])

    def test_autodiff_adjoint_cotangent_raises(self):
        solver = T.CompiledSolver(T.AutoDiffAdjoint("dopri5"))
        with pytest.raises(TypeError, match="gradient programs"):
            solver.solve(decay, np.ones((2, 3)), None, t_start=0.0, t_end=1.0, args=1.0,
                         cotangent=np.ones((2, 3)), device="cpu")
        with pytest.raises(TypeError, match="gradient programs"):
            solver.cache_key(decay, np.ones((2, 3)), None, t_start=0.0, t_end=1.0,
                             cotangent=np.ones((2, 3)), device="cpu")


# ---------------------------------------------------------------------------
# sharded_solve.


# A shard stops evaluating the dynamics once its own instances are done, so
# the whole-batch overhang count n_f_evals differs from the unsharded solve's
# (as in the JAX package); every other field is equal.
OVERHANG = ("n_f_evals",)


class TestShardedSolve:
    @pytest.mark.parametrize("n_dev", [1, 2, 3])
    def test_ragged_batch_pads_per_shard(self, n_dev):
        """Ragged batches pad with copies of instance 0, and the sliced-back
        results equal the unsharded solve bitwise (the vdp vector field is
        elementwise per instance)."""
        devices = ["cpu"] * n_dev
        for b in sorted({1, n_dev + 1, 2 * n_dev - 1, 3 * n_dev + 2}):
            y0 = np.linspace(-1.0, 1.0, 2 * b).reshape(b, 2) + 1.5
            rtol = np.where(np.arange(b) % 2 == 0, 1e-6, 1e-3)
            sol = T.sharded_solve(devices, vdp, y0, None, t_start=0.0, t_end=1.0, rtol=rtol,
                                  args=MU)
            drv = T.AutoDiffAdjoint(T.Stepper("dopri5"), rtol=rtol)
            ref = T.CompiledSolver(drv, donate=False).solve(vdp, y0, None, t_start=0.0,
                                                            t_end=1.0, args=MU, device="cpu")
            assert sol.ys.shape == (b, 2), "padding must be sliced off"
            _same(sol, ref, skip=OVERHANG)

    def test_dense_output_and_per_instance_t_eval(self):
        b = 5
        y0 = _y0(b=b)
        te = _te(n=7)
        sol = T.sharded_solve(["cpu", "cpu"], vdp, y0, te, args=MU, rtol=1e-6)
        ref = T.AutoDiffAdjoint(T.Stepper("dopri5"), rtol=1e-6).solve(vdp, y0, te, args=MU,
                                                                      device="cpu")
        assert sol.ys.shape == (b, 7, 2)
        _same(sol, ref, skip=OVERHANG)
        # A 1-D t_eval of length b is still a shared grid, not a batch axis.
        te_b = _te(n=b)
        sol = T.sharded_solve(["cpu", "cpu"], vdp, y0, te_b, args=MU, rtol=1e-6)
        _same(sol, T.AutoDiffAdjoint(T.Stepper("dopri5"), rtol=1e-6).solve(
            vdp, y0, te_b, args=MU, device="cpu"), skip=OVERHANG)
        # A (b, n) t_eval is split with the batch.
        te2 = np.stack([_te(n=6, end=1.0 + 0.2 * i) for i in range(b)])
        sol = T.sharded_solve(["cpu", "cpu"], vdp, y0, te2, args=MU, rtol=1e-6)
        _same(sol, T.AutoDiffAdjoint(T.Stepper("dopri5"), rtol=1e-6).solve(
            vdp, y0, te2, args=MU, device="cpu"), skip=OVERHANG)

    def test_cached_per_point(self):
        TC._SHARDED_CACHE.clear()
        hits, misses = TC._SHARDED_CACHE.hits, TC._SHARDED_CACHE.misses
        y0 = _y0(b=6)
        for _ in range(2):
            T.sharded_solve(["cpu", "cpu"], vdp, y0, None, t_start=0.0, t_end=1.0, args=MU)
        assert len(TC._SHARDED_CACHE) == 1
        assert (TC._SHARDED_CACHE.hits - hits, TC._SHARDED_CACHE.misses - misses) == (1, 1)

    def test_against_jax_sharded_solve_float64(self):
        from jax.sharding import Mesh

        b = 7
        y0 = _y0(b=b)
        te = _te(n=9)
        rtol = np.where(np.arange(b) % 3 == 0, 1e-9, 1e-6)
        with jax.enable_x64(True):
            mesh = Mesh(np.array(jax.devices()), ("data",))
            jsol = J.sharded_solve(mesh, vdp_jax, jnp.asarray(y0), jnp.asarray(te),
                                   rtol=jnp.asarray(rtol), atol=1e-10, args=jnp.asarray(MU))
            jys, jsteps = np.asarray(jsol.ys), np.asarray(jsol.stats["n_steps"])
            jacc = np.asarray(jsol.stats["n_accepted"])
        sol = T.sharded_solve(["cpu"] * 3, vdp, y0, te, rtol=rtol, atol=1e-10, args=MU)
        np.testing.assert_array_equal(sol.stats["n_steps"].numpy(), jsteps)
        np.testing.assert_array_equal(sol.stats["n_accepted"].numpy(), jacc)
        np.testing.assert_allclose(sol.ys.numpy(), jys, rtol=1e-9, atol=1e-9)

    def test_solver_kwarg_conflict_raises(self):
        drv = T.AutoDiffAdjoint(T.Stepper("dopri5"))
        with pytest.raises(TypeError, match="to the driver given"):
            T.sharded_solve(["cpu"], decay, np.ones((4, 2)), None, t_start=0.0, t_end=1.0,
                            solver=drv, rtol=1e-9)
        with pytest.raises(ValueError, match="at least one device"):
            T.sharded_solve([], decay, np.ones((4, 2)), None, t_start=0.0, t_end=1.0)


def test_exports_match_the_reference():
    for name in ("CompiledSolver", "CompiledSolve", "CacheInfo", "sharded_solve"):
        assert name in T.__all__ and hasattr(T, name)
        assert name in J.__all__ or hasattr(J.compiled, name)


def test_slice_batch():
    sol = T.solve_ivp(vdp, _y0(), _te(n=5), args=MU, device="cpu")
    part = sol.slice_batch(slice(2, 5))
    assert part.ys.shape == (3, 5, 2) and torch.equal(part.ys, sol.ys[2:5])
    assert torch.equal(part.stats["n_steps"], sol.stats["n_steps"][2:5])
    assert part.event_t is None
