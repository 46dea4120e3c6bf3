"""The port's fused step path (``fused=True``) against the JAX package's.

- (a) ``ref.poly_eval``, ``ref.fused_step`` and ``ref.fused_step_poly`` against
  ``repro.kernels.ref`` of the same name on the same numpy inputs, for every
  explicit tableau, pid and fixed mode, the three tolerance shapes and
  ``failed`` None and set: float32 at rtol = atol = 1e-6, float64 at 1e-12
  (as ``test_torch_ops.py``).  A decision may differ only on a row whose
  ratio lies within 1e-4 of 1 (none does on these inputs).
- (b) one small case of each against the Pallas kernel in interpret mode, at
  f = 37 (single pass) and f = 200 (the feature-tiled schedule), at the
  tolerances ``tests/test_fused_step.py`` holds that kernel to.
- (c) fused solves bitwise equal to unfused solves on the CPU, for every
  explicit tableau x {general vf, ``polynomial_term``}, dense output on and
  off.
- (d) fused solves against the JAX package's fused solves in float64: equal
  step counts, ``ys`` within 1e-9.
- (e) ``FusedFallbackReason``: when the fused path engages and why not.

The CUDA kernels themselves are held to these plain versions on the card in
``test_torch_kernels_card.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.core.stepper import _tableau_arrays as j_tableau_arrays  # noqa: E402
from repro.kernels import pallas_impl  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core.stepper import _tableau_arrays  # noqa: E402
from repro_torch.kernels import cuda_impl, ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = {np.float32: 1e-6, np.float64: 1e-12}
EXPLICIT = sorted(n for n, tab in T.TABLEAUS.items() if not tab.implicit)
DTYPES = [np.float32, np.float64]
PID = T.pid_controller()
TORCH_DTYPE = {np.float32: torch.float32, np.float64: torch.float64}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _jax(fn, dtype):
    """Run ``fn`` with JAX in the dtype's precision; numpy results out."""
    with jax.enable_x64(dtype == np.float64):
        return jax.tree_util.tree_map(np.asarray, fn())


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    """numpy arrays to tensors; Python numbers pass as they are."""
    return torch.tensor(x) if isinstance(x, np.ndarray) else x


def _inputs(seed, b, f, s, dtype, dt_scale=1.0):
    """One step attempt's inputs, as tests/test_fused_step.py makes them."""
    rng = np.random.default_rng(seed)
    y = rng.uniform(0.5, 1.5, (b, f)).astype(dtype)
    K = rng.standard_normal((s, b, f)).astype(dtype)
    t = rng.uniform(0.0, 1.0, b).astype(dtype)
    dt_cur = (dt_scale * rng.uniform(0.05, 0.2, b)).astype(dtype)
    safe_dt = (dt_cur * dtype(0.9)).astype(dtype)
    cols = (t, (t + safe_dt).astype(dtype), dt_cur, safe_dt, rng.uniform(size=b) > 0.25,
            rng.uniform(0.5, 2.0, b).astype(dtype), rng.uniform(0.5, 2.0, b).astype(dtype))
    failed = rng.uniform(size=b) < 0.2
    return y, K, cols, failed, rng


def _tolerances(kind, b, f, a0, rng, dtype):
    """atol, rtol of the given shape: a0 * factor and 1e-3 * factor, with a
    factor in [1, 1.5] per row or element."""
    if kind == "scalar":
        return a0, 1e-3
    fac = rng.uniform(1.0, 1.5, (b,) if kind == "row" else (b, f)).astype(dtype)
    return (a0 * fac).astype(dtype), (1e-3 * fac).astype(dtype)


def _mixed_atol(ratio_at_005, running):
    """tests/test_fused_step.py's pick: the scale is atol-dominated, so ratio
    ~ 1/atol and rescaling by the running rows' median straddles 1."""
    live = np.asarray(ratio_at_005)[np.asarray(running)]
    return float(0.05 * np.median(live)) if live.size and live.any() else 0.05


def _assert_step_close(got, want, dtype, rtol=None, atol=None, edge=1e-4):
    """Outputs of a fused step, decision-aware: rows that decided apart must
    have a ratio within ``edge`` of 1 and are left out of the outputs that
    follow the decision."""
    rtol = TOL[dtype] if rtol is None else rtol
    atol = TOL[dtype] if atol is None else atol
    got = [_np(x) for x in got[:9]] + [got[9]]
    want = [_np(x) for x in want[:9]] + [want[9]]
    ratio = want[1].astype(np.float64)
    differ = got[2] != want[2]
    assert np.all(~differ | (np.abs(ratio - 1.0) <= edge))
    keep = ~differ
    for k in range(9):
        g, w = got[k], want[k]
        if k >= 2:
            g, w = g[keep], w[keep]
        if k == 2:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
    assert (got[9] is None) == (want[9] is None)
    for g, w in zip(got[9] or (), want[9] or ()):
        np.testing.assert_allclose(_np(g), _np(w), rtol=rtol, atol=atol)


def _ctrl(name, mode):
    tab = T.get_tableau(name)
    return PID.filter_params(tab.error_order) if mode == "pid" else ()


# --------------------------------------------------------------------- (a)

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("coeffs", [(0.0, -1.0), (0.0, 1.0, -1.0), (0.25,),
                                    (0.5, (-1.5, -1.0, -0.5))],
                         ids=["decay", "logistic", "constant", "per_feature"])
def test_poly_eval(dtype, coeffs):
    y = np.random.default_rng(0).uniform(-2.0, 2.0, (5, 3)).astype(dtype)
    want = _jax(lambda: jref.poly_eval(jnp.asarray(y), coeffs), dtype)
    for fn in (tref.poly_eval, ops.poly_eval):
        got = fn(torch.tensor(y), coeffs)
        assert got.shape == y.shape and got.dtype == torch.tensor(y).dtype
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_failed", [False, True], ids=["failed=None", "failed=set"])
@pytest.mark.parametrize("mode", ["pid", "fixed"])
@pytest.mark.parametrize("name", EXPLICIT)
def test_fused_step_matches_jax_ref(name, mode, with_failed, dtype):
    tab = T.get_tableau(name)
    b, f = 9, 7
    y, K, cols, failed, rng = _inputs(sum(name.encode()), b, f, tab.stages, dtype)
    _, _, b_sol, b_err = _tableau_arrays(tab, TORCH_DTYPE[dtype])
    kw = dict(b_sol=b_sol, b_err=b_err, ctrl=_ctrl(name, mode), ctrl_mode=mode)
    fail = failed if with_failed else None
    tcols = [torch.tensor(c) for c in cols]
    probe = tref.fused_step(torch.tensor(y), torch.tensor(K), torch.tensor(K[-1]), *tcols,
                            0.05, 1e-3, want_coeffs=False, **kw)[1]
    a0 = _mixed_atol(probe.numpy(), cols[4])
    for kind in ("scalar", "row", "full"):
        atol, rtol = _tolerances(kind, b, f, a0, rng, dtype)
        for want_coeffs in (True, False):
            def jax_step():
                return jref.fused_step(
                    jnp.asarray(y), jnp.asarray(K), jnp.asarray(K[-1]),
                    *[jnp.asarray(x) for x in cols], atol, rtol,
                    b_sol=tuple(b_sol.tolist()), b_err=tuple(b_err.tolist()),
                    ctrl=kw["ctrl"], want_coeffs=want_coeffs, ctrl_mode=mode,
                    failed=None if fail is None else jnp.asarray(fail))
            want = _jax(jax_step, dtype)
            for fn in (tref.fused_step, ops.fused_step):
                got = fn(torch.tensor(y), torch.tensor(K), torch.tensor(K[-1]), *tcols,
                         _t(atol), _t(rtol),
                         want_coeffs=want_coeffs,
                         failed=None if fail is None else torch.tensor(fail), **kw)
                _assert_step_close(got, want, dtype)
            if fail is not None:
                assert not got[2].numpy()[fail].any() and np.isinf(got[1].numpy()[fail]).all()
    if mode == "pid" and tab.b_err is not None and not with_failed:
        accept = got[2].numpy()[cols[4]]
        assert accept.any() and (~accept).any(), "want a mixed accept/reject batch"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("poly", [(0.0, 1.0, -1.0), (0.5, tuple(np.linspace(-1.5, -0.5, 7)))],
                         ids=["logistic", "per_feature"])
@pytest.mark.parametrize("mode", ["pid", "fixed"])
@pytest.mark.parametrize("name", EXPLICIT)
def test_fused_step_poly_matches_jax_ref(name, mode, poly, dtype):
    tab = T.get_tableau(name)
    b, f = 9, 7
    y, _, cols, _, rng = _inputs(3 + sum(name.encode()), b, f, tab.stages, dtype, 4.0)
    a, c, b_sol, b_err = _tableau_arrays(tab, TORCH_DTYPE[dtype])
    ja, jc, _, _ = j_tableau_arrays(J.get_tableau(name), dtype)
    ctrl = _ctrl(name, mode)
    tcols = [torch.tensor(x) for x in cols]
    for kind in ("scalar", "row", "full"):
        atol, rtol = _tolerances(kind, b, f, 1e-4, rng, dtype)
        for want_coeffs in (True, False):
            def jax_step():
                jy = jnp.asarray(y)
                return jref.fused_step_poly(
                    jy, jref.poly_eval(jy, poly), *[jnp.asarray(x) for x in cols], atol, rtol,
                    a=tuple(map(tuple, ja.tolist())), c=tuple(jc.tolist()),
                    b_sol=tuple(b_sol.tolist()), b_err=tuple(b_err.tolist()), poly=poly,
                    ctrl=ctrl, want_coeffs=want_coeffs, fsal=tab.fsal, ctrl_mode=mode)
            want = _jax(jax_step, dtype)
            ty = torch.tensor(y)
            for fn in (tref.fused_step_poly, ops.fused_step_poly):
                got = fn(ty, tref.poly_eval(ty, poly), *tcols, _t(atol), _t(rtol), a=a, c=c, b_sol=b_sol, b_err=b_err, poly=poly,
                         ctrl=ctrl, want_coeffs=want_coeffs, fsal=tab.fsal, ctrl_mode=mode)
                _assert_step_close(got, want, dtype)


def test_fused_step_poly_is_fused_step_on_its_stages():
    """fused_step_poly = the stage recursion (the same buffer and
    stage_accum calls as rk_step) followed by fused_step: bitwise."""
    tab = T.get_tableau("heun")
    y, _, cols, _, _ = _inputs(5, 6, 4, tab.stages, np.float64)
    a, c, b_sol, b_err = _tableau_arrays(tab, TORCH_DTYPE[np.float64])
    ty, poly = torch.tensor(y), (0.0, 1.0, -1.0)
    tcols = [torch.tensor(x) for x in cols]
    f0 = tref.poly_eval(ty, poly)
    kw = dict(b_sol=b_sol, b_err=b_err, ctrl=_ctrl("heun", "pid"), want_coeffs=True)
    got = tref.fused_step_poly(ty, f0, *tcols, 1e-4, 1e-3, a=a, c=c, poly=poly,
                               fsal=False, **kw)
    K = tref.poly_stages(ty, f0, tcols[3], a, poly)
    f1 = tref.poly_eval(tref.fused_update(ty, K, tcols[3], b_sol, b_err)[0], poly)
    want = tref.fused_step(ty, K, f1, *tcols, 1e-4, 1e-3, **kw)
    for g, w in zip(list(got[:9]) + list(got[9]), list(want[:9]) + list(want[9])):
        assert torch.equal(g, w)


# --------------------------------------------------------------------- (b)

class TestPallasInterpret:
    """One small case of each fused op through the Pallas kernel in interpret
    mode, at tests/test_fused_step.py's tolerances: rtol 3e-5 single pass,
    1e-4 tiled, atol 1e-5; for polynomials the state outputs at rtol 2e-4 and
    the ratio-derived ones (err_ratio, dt_out, new_inv, new_inv2) at 3e-2
    (the embedded error estimate of a smooth polynomial cancels), decisions
    compared where the ratio is 0.05 clear of 1."""

    @pytest.mark.parametrize("b,f,rtol", [(9, 37, 3e-5), (5, 200, 1e-4)])
    def test_fused_step(self, b, f, rtol):
        tab = T.get_tableau("dopri5")
        y, K, cols, _, _ = _inputs(f, b, f, tab.stages, np.float32)
        _, _, b_sol, b_err = _tableau_arrays(tab, TORCH_DTYPE[np.float32])
        kw = dict(b_sol=tuple(b_sol.tolist()), b_err=tuple(b_err.tolist()),
                  ctrl=_ctrl("dopri5", "pid"), want_coeffs=True)
        tcols = [torch.tensor(x) for x in cols]
        probe = tref.fused_step(torch.tensor(y), torch.tensor(K), torch.tensor(K[-1]), *tcols,
                                0.05, 1e-3, **kw)[1]
        atol = _mixed_atol(probe.numpy(), cols[4])
        want = pallas_impl.fused_step(y, K, K[-1], *cols, atol, 1e-3, interpret=True, **kw)
        got = tref.fused_step(torch.tensor(y), torch.tensor(K), torch.tensor(K[-1]), *tcols,
                              atol, 1e-3, **kw)
        _assert_step_close(got, jax.tree_util.tree_map(np.asarray, want), np.float32,
                           rtol=rtol, atol=1e-5)

    @pytest.mark.parametrize("b,f", [(6, 37), (4, 200)])
    def test_fused_step_poly(self, b, f):
        tab = T.get_tableau("dopri5")
        y, _, cols, _, _ = _inputs(3 + f, b, f, tab.stages, np.float32, 4.0)
        a, c, b_sol, b_err = _tableau_arrays(tab, TORCH_DTYPE[np.float32])
        poly = (0.0, 1.0, -1.0)
        kw = dict(b_sol=tuple(b_sol.tolist()), b_err=tuple(b_err.tolist()), poly=poly,
                  ctrl=_ctrl("dopri5", "pid"), want_coeffs=True, fsal=True)
        want = jax.tree_util.tree_map(np.asarray, pallas_impl.fused_step_poly(
            y, np.asarray(jref.poly_eval(jnp.asarray(y), poly)), *cols, 1e-4, 1e-3,
            a=tuple(map(tuple, a.tolist())), c=tuple(c.tolist()), interpret=True, **kw))
        ty = torch.tensor(y)
        got = tref.fused_step_poly(ty, tref.poly_eval(ty, poly),
                                   *[torch.tensor(x) for x in cols], 1e-4, 1e-3, a=a, c=c, **kw)
        got = [_np(x) for x in got[:9]] + [got[9]]
        clear = np.abs(want[1] - 1.0) > 0.05
        np.testing.assert_array_equal(got[2][clear], want[2][clear])
        agree = got[2] == want[2]
        for k in (0,):
            np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=1e-5)
        for k in (1, 6, 7, 8):
            np.testing.assert_allclose(got[k], want[k], rtol=3e-2, atol=1e-5)
        for k in (3, 4, 5):
            np.testing.assert_allclose(got[k][agree], want[k][agree], rtol=2e-4, atol=1e-5)
        for g, w in zip(got[9], want[9]):
            np.testing.assert_allclose(_np(g), w, rtol=2e-4, atol=1e-5)


# --------------------------------------------------------------------- (c)

def _vdp(t, y, mu):
    return torch.stack((y[:, 1], mu * (1 - y[:, 0] ** 2) * y[:, 1] - y[:, 0]), dim=-1)


def _solve_kw(name, term_kind, dense):
    tab = T.get_tableau(name)
    kw = dict(method=name, device="cpu", dense=dense)
    if tab.b_err is None:
        kw.update(controller=T.FixedController(), dt0=0.05)
    else:
        kw.update(controller=T.pid_controller(), atol=1e-5, rtol=1e-5)
    if term_kind == "vf":
        rng = np.random.default_rng(0)
        y0 = (np.array([2.0, 0.0]) + 0.1 * rng.standard_normal((8, 2))).astype(np.float32)
        return _vdp, y0, np.linspace(0.0, 3.0, 13, dtype=np.float32), dict(kw, args=2.0)
    y0 = np.linspace(0.5, 1.5, 12, dtype=np.float32).reshape(4, 3)
    term = T.polynomial_term(0.0, (1.0, 0.5, 0.25), -1.0)
    return term, y0, np.linspace(0.0, 2.0, 9, dtype=np.float32), kw


def _assert_solutions_bitwise(a, b):
    assert torch.equal(a.ts, b.ts) and torch.equal(a.ys, b.ys)
    assert torch.equal(a.status, b.status)
    for k in a.stats:
        assert torch.equal(a.stats[k], b.stats[k]), k


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "final_state"])
@pytest.mark.parametrize("term_kind", ["vf", "poly"])
@pytest.mark.parametrize("name", EXPLICIT)
def test_fused_solve_bitwise_equals_unfused(name, term_kind, dense):
    f, y0, te, kw = _solve_kw(name, term_kind, dense)
    if not dense:
        te, kw = None, dict(kw, t_start=0.0, t_end=float(2.0 if term_kind == "poly" else 3.0))
    unfused = T.solve_ivp(f, y0, te, **kw)
    fused = T.solve_ivp(f, y0, te, fused=True, **kw)
    assert int(fused.status.max()) == 0
    assert torch.equal(fused.stats.pop("n_fused_steps"), fused.stats["n_steps"])
    assert torch.equal(fused.stats.pop("fused_fallback_reason"),
                       torch.zeros_like(fused.stats["n_steps"]))
    _assert_solutions_bitwise(fused, unfused)


def test_fused_step_function_bitwise_with_window_and_make_solver():
    """The windowed dense output and the bare make_solver triple take the
    fused path too, bitwise."""
    f, y0, te, kw = _solve_kw("tsit5", "vf", True)
    a = T.solve_ivp(f, y0, te, dense_window=3, **kw)
    b = T.solve_ivp(f, y0, te, dense_window=3, fused=True, **kw)
    assert torch.equal(a.ys, b.ys) and torch.equal(a.stats["n_steps"], b.stats["n_steps"])
    init, step, finish = T.make_solver(f, method="tsit5", rtol=1e-5, atol=1e-5, fused=True)
    state, consts = init(torch.tensor(y0), torch.tensor(te), args=2.0)
    for _ in range(200):
        if not bool(state.running.any()):
            break
        state = step(state, consts, 2.0)
    sol = finish(state, consts)
    assert "n_fused_steps" in sol.stats and int(sol.status.max()) == 0


# --------------------------------------------------------------------- (d)

def _jax_vdp(t, y, mu):
    return jnp.stack((y[:, 1], mu * (1 - y[:, 0] ** 2) * y[:, 1] - y[:, 0]), axis=-1)


@pytest.mark.parametrize("case", ["vdp_dopri5", "vdp_tsit5", "vdp_heun", "poly_dopri5",
                                  "poly_bosh3", "poly_rk4_fixed"])
def test_fused_solve_matches_jax_fused_float64(case):
    kind, method = case.split("_")[0], case.split("_")[1]
    rng = np.random.default_rng(0)
    if kind == "vdp":
        y0 = np.array([2.0, 0.0]) + 0.1 * rng.standard_normal((16, 2))
        te = np.linspace(0.0, 6.0, 50)
        kw = dict(method=method, atol=1e-6, rtol=1e-6, args=2.0)
        jf, tf = _jax_vdp, _vdp
    else:
        y0 = rng.uniform(0.5, 1.5, (6, 4))
        te = np.linspace(0.0, 2.0, 11)
        kw = dict(method=method, atol=1e-8, rtol=1e-6)
        if case.endswith("fixed"):
            kw = dict(method=method, dt0=0.01)
        coeffs = (0.0, (1.0, 0.5, 0.25, 0.125), -1.0)
        jf, tf = J.polynomial_term(*coeffs), T.polynomial_term(*coeffs)
    with jax.enable_x64(True):
        want = J.solve_ivp(jf, jnp.asarray(y0), jnp.asarray(te), fused=True, **kw)
        want = jax.tree_util.tree_map(np.asarray, (want.ys, want.status, want.stats))
    got = T.solve_ivp(tf, y0, te, fused=True, device="cpu", **kw)
    assert got.ys.dtype == torch.float64
    np.testing.assert_array_equal(got.status.numpy(), want[1])
    for k in ("n_steps", "n_accepted", "n_f_evals", "n_fused_steps", "fused_fallback_reason"):
        np.testing.assert_array_equal(got.stats[k].numpy(), want[2][k], err_msg=k)
    np.testing.assert_allclose(got.ys.numpy(), want[0], rtol=1e-9, atol=1e-9)


# --------------------------------------------------------------------- (e)

class TestFusedFallbackReason:
    """The engagement report (tests/test_fused_step.py's counterparts): when
    ``fused=True`` is requested, ``stats["fused_fallback_reason"]`` says
    whether the fused path ran and, if not, why."""

    def _solve(self, fused, **kw):
        kw.setdefault("method", "dopri5")
        return T.solve_ivp(lambda t, y, args: -y, np.ones((3, 4), np.float32),
                           np.linspace(0.0, 1.0, 5), fused=fused, device="cpu", **kw)

    def test_codes_match_the_jax_package(self):
        assert {m.name: m.value for m in T.FusedFallbackReason} == {
            m.name: m.value for m in J.FusedFallbackReason}

    def test_engaged(self):
        sol = self._solve(True)
        np.testing.assert_array_equal(sol.stats["fused_fallback_reason"].numpy(),
                                      np.full(3, int(T.FusedFallbackReason.ENGAGED)))
        assert torch.equal(sol.stats["n_fused_steps"], sol.stats["n_steps"])

    def test_absent_when_not_requested(self):
        stats = self._solve(False).stats
        assert "fused_fallback_reason" not in stats and "n_fused_steps" not in stats

    def test_explicit_rk_subclass_falls_back(self):
        class CustomRK(T.ExplicitRK):
            pass

        sol = self._solve(True, method=CustomRK("dopri5"))
        np.testing.assert_array_equal(sol.stats["fused_fallback_reason"].numpy(),
                                      np.full(3, int(T.FusedFallbackReason.NOT_EXPLICIT_RK)))
        assert "n_fused_steps" not in sol.stats

    def test_unsupported_controller_solves_unfused(self):
        class LenientController(T.PIDController):
            def __call__(self, err_ratio, dt, state, k):
                accept, dt_next, new_state = super().__call__(err_ratio, dt, state, k)
                return accept | (err_ratio <= 2.0), dt_next, new_state

        sol = self._solve(True, controller=LenientController())
        np.testing.assert_array_equal(
            sol.stats["fused_fallback_reason"].numpy(),
            np.full(3, int(T.FusedFallbackReason.UNSUPPORTED_CONTROLLER)))
        assert "n_fused_steps" not in sol.stats
        unfused = self._solve(False, controller=LenientController())
        assert torch.equal(sol.ys, unfused.ys)
        np.testing.assert_allclose(sol.ys[:, -1].numpy(), np.exp(-1.0), rtol=1e-3)

    def test_polynomial_term_data(self):
        term = T.polynomial_term(0, [1, 2], -1.0)
        assert isinstance(term, T.PolynomialTerm)
        assert term.poly_coeffs == (0.0, (1.0, 2.0), -1.0)
        assert term.poly_coeffs == J.polynomial_term(0, [1, 2], -1.0).poly_coeffs
        with pytest.raises(ValueError, match="at least one"):
            T.polynomial_term()


class TestNoHiddenFallback:
    def test_cuda_wrappers_refuse_cpu_tensors(self):
        before = dict(ops.launches)
        tab = T.get_tableau("dopri5")
        y, K, cols, _, _ = _inputs(0, 3, 2, tab.stages, np.float32)
        a, c, b_sol, b_err = _tableau_arrays(tab, TORCH_DTYPE[np.float32])
        ty, tK = torch.tensor(y), torch.tensor(K)
        tcols = [torch.tensor(x) for x in cols]
        kw = dict(b_sol=b_sol, b_err=b_err, ctrl=_ctrl("dopri5", "pid"), want_coeffs=True)
        with pytest.raises(ValueError, match="CUDA tensors"):
            cuda_impl.fused_step(ty, tK, tK[-1], *tcols, 1e-6, 1e-3, **kw)
        with pytest.raises(ValueError, match="CUDA tensors"):
            cuda_impl.fused_step_poly(ty, ty, *tcols, 1e-6, 1e-3, a=a, c=c, poly=(0.0, -1.0),
                                      **kw)
        assert ops.launches == before

    def test_unknown_device_raises(self):
        y = torch.ones(2, 3, device="meta")
        col = torch.ones(2, device="meta")
        with pytest.raises(ValueError, match="no implementation"):
            ops.fused_step(y, torch.ones(1, 2, 3, device="meta"), y, col, col, col, col,
                           col.bool(), col, col, 1e-6, 1e-3, b_sol=[1.0], b_err=[0.0],
                           ctrl=(), want_coeffs=False, ctrl_mode="fixed")
