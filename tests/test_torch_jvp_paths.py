"""Forward mode through every solver path of the port against ``jax.jvp`` of
the JAX package, in float64 on the CPU.

``torch.func.jvp`` of the port's ``solve_ivp`` / ``solve_ivp_scan`` is held
to ``jax.jvp`` of the reference's along the same tangents (drawn with numpy
from a seed) in y0, in the vector field's parameters and, on dopri5, in
``t_eval``: every tangent within 1e-10 of its largest entry, with equal
step, event, Newton and Jacobian counts.  The paths: dopri5 and tsit5
unfused and ``fused=True``, ``fused_step_poly`` (a ``polynomial_term``), a
terminal and a non-terminal event (the tangents of ``ys``, ``event_t`` and
``event_y``), kvaerno5 unfused and factor-once (the stiff path: all four
Newton ops), a structured (dict) state and ``solve_ivp_scan`` with
``checkpoint_every`` 0 and 16.  ``dense_window > 0`` is held to the port's
own full-mask tangent (the reference raises there under x64, ROADMAP C-4).
``torch.autograd.forward_ad`` gives the same tangents on the explicit,
fused, event and scan paths and refuses the implicit steppers' nested
Jacobian with a ``RuntimeError`` that names ``torch.func.jvp``.

Also: the forward tangent against the reverse gradient on the port
(<J v, w> = <v, J^T w>), on the CPU and through the kernels' Functions (the
``card`` stand-ins of ``tests/test_torch_jvp.py``); ``BacksolveAdjoint`` and
``SolveService`` refuse a tangent; ``CompiledSolver`` runs a forward-mode
entry's eager loop, says why, and gives the eager solve's tangent bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.kernels import cuda_impl, ops  # noqa: E402
from repro_torch.tools import grad_checks  # noqa: E402

TOL = 1e-10
B, F = 3, 2
RNG = np.random.default_rng(7)
Y0 = RNG.uniform(0.5, 1.5, (B, F))
A = RNG.uniform(0.5, 2.0, F)
TE = np.linspace(0.0, 2.0, 5)
TANS = {"y0": RNG.standard_normal((B, F)), "args": RNG.standard_normal(F),
        "t_eval": 1e-2 * RNG.standard_normal(TE.shape)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _jvf(t, y, a):
    return -a * y + 0.1 * jnp.sin(t)[:, None] * y * y


def _tvf(t, y, a):
    return -a * y + 0.1 * torch.sin(t)[:, None] * y * y


def _jstiff(t, y, lam):
    return -lam * y + 0.5 * jnp.roll(y, 1, axis=1) - y * y * y


def _tstiff(t, y, lam):
    return -lam * y + 0.5 * torch.roll(y, 1, dims=1) - y * y * y


def _outputs(sol):
    outs = [sol.ys]
    if sol.event_t is not None:
        outs += [sol.event_t, sol.event_y]
    return outs


_JAX_RUNS = {}


def _jax(solve, vf, wrt, prim, **kw):
    """``jax.jvp`` of the reference's solve along ``TANS`` in ``wrt``:
    (tangents as numpy, counts); each point run once in the module."""
    key = (solve.__name__, vf, wrt, repr(sorted(kw.items())), repr(TANS.get("y0")[0]))
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = _jax_run(solve, vf, wrt, prim, **kw)
    return _JAX_RUNS[key]


def _jax_run(solve, vf, wrt, prim, **kw):
    with jax.enable_x64(True):
        given = {k: None if v is None else jnp.asarray(v) for k, v in prim.items()}

        def run(*xs):
            g = dict(given, **dict(zip(wrt, xs)))
            return _outputs(solve(vf, g["y0"], g["t_eval"], args=g["args"], **kw))

        _, touts = jax.jvp(run, tuple(given[k] for k in wrt),
                           tuple(jnp.asarray(TANS[k]) for k in wrt))
        sol = solve(vf, given["y0"], given["t_eval"], args=given["args"], **kw)
        counts = {k: np.asarray(sol.stats[k]) for k in grad_checks.COUNTS if k in sol.stats}
        return [np.asarray(t) for t in touts], counts


def _port(solve, vf, wrt, prim, mode="func", **kw):
    """The port's forward-mode solve on the CPU: (tangents, counts, sol)."""
    given = {k: None if v is None else torch.as_tensor(np.asarray(v)) for k, v in prim.items()}
    box = {}

    def run(*xs):
        g = dict(given, **dict(zip(wrt, xs)))
        box["sol"] = solve(vf, g["y0"], g["t_eval"], args=g["args"], device="cpu", **kw)
        return tuple(_outputs(box["sol"]))

    primals = tuple(given[k] for k in wrt)
    dirs = tuple(torch.as_tensor(TANS[k]) for k in wrt)
    if mode == "func":
        _, touts = torch.func.jvp(run, primals, dirs)
    else:
        with torch.autograd.forward_ad.dual_level():
            outs = run(*(torch.autograd.forward_ad.make_dual(p, t)
                         for p, t in zip(primals, dirs)))
            touts = [torch.autograd.forward_ad.unpack_dual(o).tangent for o in outs]
    return [t.numpy() for t in touts], grad_checks._counts(box["sol"]), box["sol"]


def _hold(got, want, label):
    """Equal NaN entries, every other within TOL of the largest entry."""
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (label, i, g.shape, w.shape)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f"{label}: out {i}")
        fin = np.isfinite(w)
        scale = max(float(np.abs(w[fin]).max()) if fin.any() else 0.0, 1e-300)
        err = float(np.abs(g[fin] - w[fin]).max()) if fin.any() else 0.0
        assert err <= TOL * scale, f"{label}: out {i} differs by {err} (largest {scale})"


def _counts_equal(got, want, label):
    assert set(got) == set(want), (label, set(got), set(want))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{label}: {k}")


PRIM = {"y0": Y0, "args": A, "t_eval": TE}
KW = dict(rtol=1e-8, atol=1e-8)
# (name, reference solve kwargs, the port's variants held to it).  The port's
# fused and unfused solves agree bitwise (tests/test_torch_fused.py), as the
# reference's do: both are held to one reference tangent.
EXPLICIT = {
    "dopri5": (dict(method="dopri5"), (dict(), dict(fused=True))),
    "tsit5": (dict(method="tsit5"), (dict(), dict(fused=True))),
}


@pytest.mark.parametrize("method", list(EXPLICIT))
def test_explicit_paths_match_jax(method):
    """dopri5 (tangents in y0, args and t_eval) and tsit5 (y0 and args),
    unfused and ``fused=True``, under ``torch.func.jvp`` and ``forward_ad``."""
    jkw, variants = EXPLICIT[method]
    wrt = ("y0", "args", "t_eval") if method == "dopri5" else ("y0", "args")
    want, wcounts = _jax(J.solve_ivp, _jvf, wrt, PRIM, **KW, **jkw)
    for extra in variants:
        for mode in ("func", "forward_ad"):
            label = f"{method} {extra} {mode}"
            got, counts, _ = _port(T.solve_ivp, _tvf, wrt, PRIM, mode=mode, **KW, **jkw,
                                   **extra)
            _counts_equal(counts, wcounts, label)
            _hold(got, want, label)


def test_polynomial_fused_matches_jax():
    """``fused_step_poly``: the logistic as a ``polynomial_term``, tangent in
    y0 (its coefficients are static)."""
    prim = dict(PRIM, args=None)
    want, wcounts = _jax(J.solve_ivp, J.polynomial_term(0.0, 1.0, -1.0), ("y0",), prim,
                         fused=True, **KW)
    for mode in ("func", "forward_ad"):
        got, counts, _ = _port(T.solve_ivp, T.polynomial_term(0.0, 1.0, -1.0), ("y0",), prim,
                               mode=mode, fused=True, **KW)
        _counts_equal(counts, wcounts, f"poly {mode}")
        _hold(got, want, f"poly {mode}")


def _events(lib):
    mark = lib.Event(lambda t, y, args: (y[0] - 0.75) * (y[0] - 0.55), terminal=False)
    stop = lib.Event(lambda t, y, args: y[1] - 0.4, terminal=True, direction=-1.0)
    return mark, stop


# The event time's tangent is t0' + x dt' (the bracket carries none, in both
# packages): it carries the step size's tangent, which the controller takes
# from the error estimate's -- a difference of stages ~rtol their size, so
# either framework's rounding of the stages' tangents reaches it magnified
# ~1/rtol (3e-9 of 0.27 at rtol = 1e-8, 1.3e-10 of 0.29 at 1e-5).  At the
# solver's default tolerances it stays far below TOL, and the bound measures
# the formulas.
EVENT_KW = dict(rtol=1e-3, atol=1e-6)


def test_events_match_jax():
    """A non-terminal and a terminal event in one solve: the tangents of
    ``ys``, ``event_t`` and ``event_y``, and equal event counts."""
    want, wcounts = _jax(J.solve_ivp, _jvf, ("y0", "args"), PRIM, events=_events(J),
                         **EVENT_KW)
    assert wcounts["n_events"].min() >= 1
    for mode in ("func", "forward_ad"):
        got, counts, sol = _port(T.solve_ivp, _tvf, ("y0", "args"), PRIM, mode=mode,
                                 events=_events(T), **EVENT_KW)
        assert (sol.status.numpy() == T.Status.EVENT.value).any()
        _counts_equal(counts, wcounts, f"events {mode}")
        _hold(got, want, f"events {mode}")


STIFF = {"y0": RNG.uniform(0.2, 1.0, (B, 4)), "args": np.asarray(50.0),
         "t_eval": np.linspace(0.0, 0.1, 3)}
TANS["stiff_y0"] = RNG.standard_normal((B, 4))
TANS["stiff_lam"] = np.asarray(RNG.standard_normal())


@pytest.mark.parametrize("fused", [False, True])
def test_kvaerno5_matches_jax(fused, monkeypatch):
    """The stiff path, unfused (``batched_linsolve`` + ``masked_newton_update``)
    and factor-once (``batched_lu_factor`` + ``fused_newton_iter``): the chord
    matrix carries its own tangent (the Jacobian's jvp nests), with equal
    Newton and Jacobian counts.  Under ``forward_ad`` the nested Jacobian
    cannot run, and the solve raises naming ``torch.func.jvp``."""
    monkeypatch.setitem(TANS, "y0", TANS["stiff_y0"])
    monkeypatch.setitem(TANS, "args", TANS["stiff_lam"])
    kw = dict(method="kvaerno5", rtol=1e-6, atol=1e-8)
    # The reference's factor-once solve equals its unfused one, as the port's
    # do (tests/test_torch_stiff.py): one reference tangent for both.
    want, wcounts = _jax(J.solve_ivp, _jstiff, ("y0", "args"), STIFF, **kw)
    kw["fused"] = fused
    assert wcounts["n_newton_iters"].min() > 0
    got, counts, _ = _port(T.solve_ivp, _tstiff, ("y0", "args"), STIFF, **kw)
    _counts_equal(counts, wcounts, f"kvaerno5 fused={fused}")
    _hold(got, want, f"kvaerno5 fused={fused}")
    with pytest.raises(RuntimeError, match="torch.func.jvp"):
        _port(T.solve_ivp, _tstiff, ("y0", "args"), STIFF, mode="forward_ad", **kw)


def test_dense_window_matches_full_mask():
    """``dense_window = 2``: the windowed writes' tangent equals the port's
    full-mask one (the reference raises under x64, ROADMAP C-4)."""
    want, wcounts, _ = _port(T.solve_ivp, _tvf, ("y0", "args", "t_eval"), PRIM, **KW)
    got, counts, _ = _port(T.solve_ivp, _tvf, ("y0", "args", "t_eval"), PRIM, dense_window=2,
                           **KW)
    _counts_equal(counts, wcounts, "dense_window")
    _hold(got, want, "dense_window")


def test_structured_state_matches_jax():
    """A per-instance dict state (no entry 0: abs'(0) differs, ROADMAP C):
    the tangent of each leaf of ``ys``."""
    y0 = {"x": np.array([[2.0], [1.5], [-1.0]]), "v": np.array([[0.1], [0.5], [0.2]])}
    tan = {"x": RNG.standard_normal((B, 1)), "v": RNG.standard_normal((B, 1))}

    def jvdp(t, y, mu):
        return {"x": y["v"], "v": mu * (1 - y["x"] ** 2) * y["v"] - y["x"]}

    kw = dict(rtol=1e-7, atol=1e-9)
    with jax.enable_x64(True):
        jy0 = {k: jnp.asarray(v) for k, v in y0.items()}
        _, jt = jax.jvp(lambda y: J.solve_ivp(jvdp, y, jnp.asarray(TE), args=2.0, **kw).ys,
                        (jy0,), ({k: jnp.asarray(v) for k, v in tan.items()},))
        steps = np.asarray(J.solve_ivp(jvdp, jy0, jnp.asarray(TE), args=2.0, **kw)
                           .stats["n_steps"])
    ty0 = {k: torch.as_tensor(v) for k, v in y0.items()}
    box = {}

    def run(y):
        box["sol"] = T.solve_ivp(jvdp, y, TE, args=2.0, device="cpu", **kw)
        return box["sol"].ys

    _, tt = torch.func.jvp(run, (ty0,), ({k: torch.as_tensor(v) for k, v in tan.items()},))
    np.testing.assert_array_equal(box["sol"].stats["n_steps"].numpy(), steps)
    for k in y0:
        _hold([tt[k].numpy()], [np.asarray(jt[k])], f"dict {k}")


@pytest.mark.parametrize("mode", ["func", "forward_ad"])
def test_scan_checkpointed_matches_jax(mode):
    """``solve_ivp_scan`` (``ScanAdjoint``) with ``checkpoint_every`` 0 and 16
    -- 40 steps: two blocks and a remainder of 8 -- against the reference's
    scan."""
    kw = dict(max_steps=40, **KW)
    want, wcounts = _jax(J.solve_ivp_scan, _jvf, ("y0", "args"), PRIM, **kw)
    for every in (0, 16):
        got, counts, _ = _port(T.solve_ivp_scan, _tvf, ("y0", "args"), PRIM, mode=mode,
                               checkpoint_every=every, **kw)
        _counts_equal(counts, wcounts, f"scan every={every}")
        _hold(got, want, f"scan every={every} {mode}")


# ------------------------------------------------------- forward vs reverse


@pytest.fixture
def card(monkeypatch):
    """The solver ops on their CUDA route on CPU tensors, each kernel stood
    in by its plain op (``grad_checks.stand_in``), counted."""
    for name in grad_checks.OPS:
        monkeypatch.setattr(cuda_impl, name, grad_checks.stand_in(name))
    monkeypatch.setattr(ops, "_on_cuda", lambda name, t: name in grad_checks.OPS)
    saved = dict(cuda_impl.launches)
    cuda_impl.launches.update(dict.fromkeys(cuda_impl.launches, 0))
    yield cuda_impl.launches
    cuda_impl.launches.update(saved)


def _dot_test(method, fused, events=None):
    """<J v, w> against <v, J^T w> for the map (y0, args) -> ys."""
    kw = dict(method=method, fused=fused, rtol=1e-8, atol=1e-8, events=events)
    v = (torch.as_tensor(TANS["y0"]), torch.as_tensor(TANS["args"]))
    w = torch.as_tensor(np.random.default_rng(3).standard_normal((B, TE.size, F)))
    y0, a = torch.as_tensor(Y0), torch.as_tensor(A)
    _, jv = torch.func.jvp(lambda y, p: T.solve_ivp(_tvf, y, TE, args=p, device="cpu",
                                                      **kw).ys, (y0, a), v)
    yr, ar = y0.clone().requires_grad_(), a.clone().requires_grad_()
    ys = T.solve_ivp(_tvf, yr, TE, args=ar, device="cpu", **kw).ys
    jw = torch.autograd.grad(ys, (yr, ar), w)
    lhs = float((jv * w).sum())
    rhs = float(sum((g * t).sum() for g, t in zip(jw, v)))
    assert abs(lhs - rhs) <= TOL * max(abs(lhs), 1.0), (lhs, rhs)


@pytest.mark.parametrize("method,fused,events", [
    ("dopri5", False, False), ("dopri5", True, False), ("dopri5", False, True),
    ("kvaerno5", True, False)])
def test_forward_against_reverse(method, fused, events):
    """On the CPU's plain ops."""
    _dot_test(method, fused, _events(T) if events else None)


@pytest.mark.parametrize("method,fused,events", [
    ("dopri5", False, False), ("dopri5", True, False), ("dopri5", False, True),
    ("kvaerno5", False, False), ("kvaerno5", True, False)])
def test_forward_against_reverse_through_functions(card, method, fused, events):
    """Through the kernels' Functions: each jvp against its backward."""
    _dot_test(method, fused, _events(T) if events else None)
    assert card["fused_step" if fused else "stage_accum"] > 0


# --------------------------------------------------------------- refusals


def test_backsolve_refuses_forward_mode():
    solver = T.BacksolveAdjoint(rtol=1e-6, atol=1e-8)
    with pytest.raises(TypeError, match="AutoDiffAdjoint"):
        torch.func.jvp(lambda y: solver.solve(_tvf, y, t_start=0.0, t_end=1.0,
                                              args=torch.as_tensor(A), device="cpu"),
                       (torch.as_tensor(Y0),), (torch.as_tensor(TANS["y0"]),))
    with torch.autograd.forward_ad.dual_level():
        y = torch.autograd.forward_ad.make_dual(torch.as_tensor(Y0),
                                                torch.ones(B, F, dtype=torch.float64))
        with pytest.raises(TypeError, match="AutoDiffAdjoint"):
            solver.solve(_tvf, y, t_start=0.0, t_end=1.0, args=torch.as_tensor(A), device="cpu")


def test_service_refuses_a_tangent():
    svc = T.SolveService(devices=["cpu"])
    req = lambda y: T.SolveRequest(f=_tvf, y0=y, t0=0.0, t1=1.0, args=torch.as_tensor(A))
    with torch.autograd.forward_ad.dual_level():
        y = torch.autograd.forward_ad.make_dual(torch.as_tensor(Y0[0]),
                                                torch.ones(F, dtype=torch.float64))
        with pytest.raises(TypeError, match="forward-mode tangent"):
            svc.submit(req(y))
    with pytest.raises(TypeError, match="forward-mode tangent"):
        torch.func.jvp(lambda y: svc.submit(req(y)), (torch.as_tensor(Y0[0]),),
                       (torch.ones(F, dtype=torch.float64),))
    assert svc.stats()["n_requests"] == 0


def test_compiled_solver_runs_forward_mode_eagerly():
    """A forward-mode entry is a class of its own: the eager loop, its
    ``why`` naming forward mode, the eager solve's tangent bitwise; the
    primal entry beside it stays captured."""
    solver = T.CompiledSolver(T.AutoDiffAdjoint("dopri5", rtol=1e-8, atol=1e-8), k=4)
    y0, a, v = torch.as_tensor(Y0), torch.as_tensor(A), torch.as_tensor(TANS["y0"])
    _, got = torch.func.jvp(lambda y: solver.solve(_tvf, y, TE, args=a, device="cpu").ys,
                            (y0,), (v,))
    _, want = torch.func.jvp(lambda y: T.solve_ivp(_tvf, y, TE, args=a, rtol=1e-8, atol=1e-8,
                                                   device="cpu").ys, (y0,), (v,))
    assert torch.equal(got, want)
    with torch.autograd.forward_ad.dual_level():
        y = torch.autograd.forward_ad.make_dual(y0, v)
        ys = solver.solve(_tvf, y, TE, args=a, device="cpu").ys
        assert torch.equal(torch.autograd.forward_ad.unpack_dual(ys).tangent, want)
    fwd = [e for e in solver._cache.data.values() if e.why is not None]
    assert len(fwd) == 1 and fwd[0].why.startswith("forward mode")
    plain = solver.solve(_tvf, y0, TE, args=a, device="cpu")
    handle = solver.compile(_tvf, y0, TE, args=a, device="cpu")
    assert handle.captured and handle.why is None
    assert torch.equal(plain.ys, T.solve_ivp(_tvf, y0, TE, args=a, rtol=1e-8, atol=1e-8,
                                             device="cpu").ys)


@pytest.mark.parametrize("mode", ["func", "forward_ad"])
def test_compiled_solver_forward_mode_in_t_end(mode):
    """A tangent on ``t_end`` alone (``y0``, ``t_eval`` and ``args`` plain)
    also makes a forward-mode entry: the eager loop and the eager solve's
    tangent, never a captured replay that drops it."""
    solver = T.CompiledSolver(T.AutoDiffAdjoint("dopri5", rtol=1e-8, atol=1e-8), k=4)
    y0, a = torch.as_tensor(Y0), torch.as_tensor(A)
    t1, v = torch.tensor(2.0, dtype=torch.float64), torch.tensor(1.0, dtype=torch.float64)

    def run(solve):
        if mode == "func":
            return torch.func.jvp(solve, (t1,), (v,))[1]
        with torch.autograd.forward_ad.dual_level():
            out = solve(torch.autograd.forward_ad.make_dual(t1, v))
            return torch.autograd.forward_ad.unpack_dual(out).tangent

    got = run(lambda t: solver.solve(_tvf, y0, t_start=0.0, t_end=t, args=a,
                                     device="cpu").ys)
    want = run(lambda t: T.solve_ivp(_tvf, y0, t_start=0.0, t_end=t, args=a, rtol=1e-8,
                                     atol=1e-8, device="cpu").ys)
    assert want is not None and float(want.abs().max()) > 1e-3
    assert torch.equal(got, want)
    (entry,) = solver._cache.data.values()
    assert entry.why.startswith("forward mode")
