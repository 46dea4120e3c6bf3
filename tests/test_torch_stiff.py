"""The port's stiff path (``DiagonallyImplicitRK`` + ``core/newton.py``)
against the JAX package's, on the same numpy inputs.

- (a) ``ref.batched_lu_factor``, ``ref.batched_linsolve``,
  ``ref.fused_newton_iter`` and ``ref.masked_newton_update`` against
  ``repro.kernels.ref`` of the same name on the chord matrices of
  ``repro_torch.tools.newton_checks`` (f in {1, 3, 5, 33, 128}; a shuffled
  chord matrix, a zero leading diagonal, tied pivots, a NaN entry; none, all
  and mixed ``active``): the permutation equal to JAX's, ``A[perm] == L @
  U``, the rest at float32 1e-5 and float64 1e-12 (``newton_checks.hold``);
  the NaN rows give a non-finite ``res_norm``.
- (b) the same ops against the Pallas kernels in interpret mode.
- (c) the plain linsolve is the plain LU and substitution, bitwise, and one
  unfused Newton iteration equals ``fused_newton_iter`` bitwise.
- (d) ``newton_solve`` on both paths against JAX's, the divergence flag
  included, and its argument checks.
- (e) float64 whole solves against JAX ``solve_ivp`` for all four implicit
  tableaus, unfused and fused: equal ``n_steps``, ``n_accepted``,
  ``n_f_evals``, ``n_newton_iters``, ``n_jac_evals`` and ``status``, ``ys``
  within 1e-9; a structured state and one event solve under kvaerno5.
- (f) fused == unfused bitwise on the CPU, the starved-Newton reject path and
  the ``FixedController`` failure (not SUCCESS) included;
  ``FusedFallbackReason.UNSUPPORTED_IMPLICIT`` for a subclass; a
  ``polynomial_term`` under an implicit stepper never takes
  ``fused_step_poly``.
- (g) ``f_jac`` against ``vf_jac``, and the legacy Newton kwargs.

The CUDA kernels are held to these plain versions on the card in
``test_torch_kernels_card.py``.
"""

import functools
import warnings
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.kernels import pallas_impl  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.tools import newton_checks as NC  # noqa: E402

DTYPES = [np.float32, np.float64]
IMPLICIT = sorted(n for n, tab in T.TABLEAUS.items() if tab.implicit)
STATS = ("n_steps", "n_accepted", "n_f_evals", "n_newton_iters", "n_jac_evals")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _jax(fn, dtype=np.float64):
    """Run ``fn`` with JAX in the dtype's precision; numpy results out."""
    with jax.enable_x64(dtype == np.float64):
        return jax.tree_util.tree_map(np.asarray, fn())


def _t(*arrays):
    return tuple(torch.as_tensor(np.array(a)) for a in arrays)


def _cases():
    for f in NC.WIDTHS:
        for kind in NC.KINDS:
            if (kind == "zero_diag" and f < 2) or (kind == "ties" and f < 3):
                continue
            yield f, kind


# ------------------------------------------------------------ (a) plain ops


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("f, kind", list(_cases()))
def test_plain_ops_match_jax(dtype, f, kind):
    b = 7
    M, rhs, k, fk, active, scale = NC.newton_inputs(f * 10 + len(kind), b, f, dtype, kind)
    skip = NC.nan_rows(M)

    @jax.jit
    def ops_jax(M, rhs, k, fk, active, scale):
        lu, perm = jref.batched_lu_factor(M)
        return (lu, perm, jref.batched_linsolve(M, rhs),
                jref.fused_newton_iter(lu, perm, k, fk, active, scale),
                jref.masked_newton_update(k, rhs, active, scale))

    lu_j, perm_j, x_j, it_j, up_j = _jax(lambda: ops_jax(M, rhs, k, fk, active, scale), dtype)
    lu_t, perm_t = tref.batched_lu_factor(torch.as_tensor(M))
    assert perm_t.dtype == torch.int32 and lu_t.dtype == torch.as_tensor(M).dtype
    NC.hold("batched_lu_factor", (lu_t, perm_t), _t(lu_j, perm_j), dtype, matrix=M,
            skip_rows=skip)
    keep = ~torch.as_tensor(skip)
    NC.lu_reconstructs(lu_t[keep], perm_t[keep], torch.as_tensor(M)[keep], dtype)

    NC.hold("batched_linsolve", (tref.batched_linsolve(*_t(M, rhs)),), _t(x_j), dtype,
            skip_rows=skip)
    got = tref.fused_newton_iter(lu_t, perm_t, *_t(k, fk, active, scale))
    NC.hold("fused_newton_iter", got, _t(*it_j), dtype, skip_rows=skip)
    if skip.any():
        assert not torch.isfinite(got[1][torch.as_tensor(skip)]).any()
    got = tref.masked_newton_update(*_t(k, rhs, active, scale))
    NC.hold("masked_newton_update", got, _t(*up_j), dtype)


@pytest.mark.parametrize("active", ["none", "all", "mixed"])
def test_masks_commit_only_active_rows(active):
    M, _, k, fk, mask, scale = NC.newton_inputs(3, 9, 5, np.float64, active=active)
    lu, perm = tref.batched_lu_factor(torch.as_tensor(M))
    for k_new, _ in (tref.fused_newton_iter(lu, perm, *_t(k, fk, mask, scale)),
                     tref.masked_newton_update(*_t(k, fk, mask, scale))):
        frozen = ~torch.as_tensor(mask)
        assert torch.equal(k_new[frozen], torch.as_tensor(k)[frozen])
        assert not torch.equal(k_new[~frozen], torch.as_tensor(k)[~frozen]) or frozen.all()


def test_scale_may_broadcast():
    M, _, k, fk, mask, scale = NC.newton_inputs(4, 6, 5, np.float64)
    lu, perm = tref.batched_lu_factor(torch.as_tensor(M))
    full = torch.full((6, 5), 1e-3, dtype=torch.float64)
    for s in (1e-3, torch.tensor(1e-3, dtype=torch.float64), full[:, :1]):
        for op, args in ((tref.fused_newton_iter, (lu, perm, *_t(k, fk, mask))),
                         (tref.masked_newton_update, _t(k, fk, mask))):
            got, want = op(*args, s), op(*args, full)
            assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_perm_is_a_permutation_not_pivots():
    """A matrix whose LAPACK pivots are not a permutation: a cyclic shift."""
    A = np.roll(np.eye(4), 1, axis=0)[None] * np.array([4.0, 3.0, 2.0, 1.0])[None, :, None]
    _, perm = tref.batched_lu_factor(torch.as_tensor(A))
    _, perm_j = _jax(lambda: jref.batched_lu_factor(jnp.asarray(A)))
    assert perm.tolist() == perm_j.tolist() == [[1, 2, 3, 0]]


# ------------------------------------------------- (b) the Pallas kernels


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("f, kind", [(3, "chord"), (5, "ties"), (33, "zero_diag"),
                                     (33, "nan")])
def test_plain_ops_match_pallas_interpret(dtype, f, kind):
    b = 5
    M, rhs, k, fk, active, scale = NC.newton_inputs(f + 100, b, f, dtype, kind)
    skip = NC.nan_rows(M)

    @jax.jit
    def run(A, rhs, k, fk, active, scale):
        lu, perm = pallas_impl.batched_lu_factor(A, interpret=True)
        x = pallas_impl.batched_linsolve(A, rhs, interpret=True)
        it = pallas_impl.fused_newton_iter(lu, perm, k, fk, active, scale, interpret=True)
        up = pallas_impl.masked_newton_update(k, rhs, active, scale, interpret=True)
        return lu, perm, x, it, up

    lu_p, perm_p, x_p, it_p, up_p = _jax(lambda: run(M, rhs, k, fk, active, scale), dtype)
    lu_t, perm_t = tref.batched_lu_factor(torch.as_tensor(M))
    NC.hold("batched_lu_factor", (lu_t, perm_t), _t(lu_p, perm_p), dtype, matrix=M,
            skip_rows=skip)
    NC.hold("batched_linsolve", (tref.batched_linsolve(*_t(M, rhs)),), _t(x_p), dtype,
            skip_rows=skip)
    NC.hold("fused_newton_iter", tref.fused_newton_iter(lu_t, perm_t, *_t(k, fk, active, scale)),
            _t(*it_p), dtype, skip_rows=skip)
    NC.hold("masked_newton_update", tref.masked_newton_update(*_t(k, rhs, active, scale)),
            _t(*up_p), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("active", ["none", "all", "mixed"])
@pytest.mark.parametrize("f", NC.UPDATE_WIDTHS)
def test_masked_newton_update_widths_match_jax(f, active, dtype):
    """``masked_newton_update`` at the boundaries of the card kernel's layout
    (``newton_checks.UPDATE_WIDTHS``: lanes, batches of 128 columns, widths
    that are not a multiple of one), inactive, all-active and mixed rows."""
    _, rhs, k, _, mask, scale = NC.newton_inputs(f + 300, 9, f, dtype, active=active)
    want = _jax(lambda: jref.masked_newton_update(*(jnp.asarray(a) for a in (
        k, rhs, mask, scale))), dtype)
    got = tref.masked_newton_update(*_t(k, rhs, mask, scale))
    NC.hold("masked_newton_update", got, _t(*want), dtype)
    frozen = ~torch.as_tensor(mask)
    assert torch.equal(got[0][frozen], torch.as_tensor(k)[frozen])


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("f", [1, 33, 129, 257])
def test_masked_newton_update_widths_match_pallas_interpret(f, dtype):
    _, rhs, k, _, mask, scale = NC.newton_inputs(f + 400, 9, f, dtype)
    want = _jax(lambda: pallas_impl.masked_newton_update(
        *(jnp.asarray(a) for a in (k, rhs, mask, scale)), interpret=True), dtype)
    NC.hold("masked_newton_update", tref.masked_newton_update(*_t(k, rhs, mask, scale)),
            _t(*want), dtype)


# ----------------------------------------------- (c) bitwise compositions


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("f", NC.WIDTHS)
def test_linsolve_is_lu_then_substitution_bitwise(dtype, f):
    M, rhs, k, fk, active, scale = NC.newton_inputs(f, 6, f, dtype)
    A = torch.as_tensor(M)
    x = tref.batched_linsolve(A, torch.as_tensor(rhs))
    assert torch.equal(x, tref._lu_solve_perm(*tref.batched_lu_factor(A), torch.as_tensor(rhs)))
    k, fk, active, scale = _t(k, fk, active, scale)
    unfused = tref.masked_newton_update(k, tref.batched_linsolve(A, k - fk), active, scale)
    fused = tref.fused_newton_iter(*tref.batched_lu_factor(A), k, fk, active, scale)
    assert all(torch.equal(a, c) for a, c in zip(unfused, fused))


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("f", NC.UPDATE_WIDTHS)
def test_unfused_iteration_is_fused_bitwise_at_update_widths(dtype, f):
    """The plain unfused iteration (linsolve, then the masked update) equals
    the plain fused one bitwise at ``masked_newton_update``'s boundary
    widths, as the card's kernels must, on the module's two threads."""
    M, _, k, fk, active, scale = NC.newton_inputs(f + 500, 4, f, dtype)
    A = torch.as_tensor(M)
    k, fk, active, scale = _t(k, fk, active, scale)
    unfused = tref.masked_newton_update(k, tref.batched_linsolve(A, k - fk), active, scale)
    fused = tref.fused_newton_iter(*tref.batched_lu_factor(A), k, fk, active, scale)
    assert all(torch.equal(a, c) for a, c in zip(unfused, fused))


# ------------------------------------------------------- (d) newton_solve


def _newton_problem(dtype):
    """A stiff implicit-Euler stage of Van der Pol, mu in {1, 10, 100, 1000}:
    ``k = f(y + h k)``, with the chord matrix at y."""
    mu = np.array([1.0, 10.0, 100.0, 1000.0])
    y = np.array([[2.0, 0.0], [1.5, -0.5], [0.5, 2.0], [-1.0, 1.0]])
    h = 0.002
    J_ = np.stack([[[0.0, 1.0], [-2 * m * yy[0] * yy[1] - 1.0, m * (1 - yy[0] ** 2)]]
                   for m, yy in zip(mu, y)])
    M = (np.eye(2) - h * J_).astype(dtype)
    scale = (1e-6 + 1e-3 * np.abs(y)).astype(dtype) / h
    return mu.astype(dtype), y.astype(dtype), h, M, scale


@pytest.mark.parametrize("path", ["M", "operator"])
@pytest.mark.parametrize("case", ["converges", "diverges"])
def test_newton_solve_matches_jax(path, case):
    mu, y, h, M, scale = _newton_problem(np.float64)
    if case == "diverges":
        M = np.broadcast_to(np.eye(2), M.shape).copy()  # no Jacobian: mu = 1000 blows up
    cfg = dict(tol=1e-2, max_iters=8)

    def run_jax():
        def eval_fn(k):
            yy = jnp.asarray(y) + h * k
            return jnp.stack((yy[:, 1], mu * (1 - yy[:, 0] ** 2) * yy[:, 1] - yy[:, 0]), -1)

        A = jnp.asarray(M)
        kw = (dict(M=A) if path == "M" else dict(operator=jref.batched_lu_factor(A)))
        return J.newton_solve(eval_fn, jnp.zeros((4, 2)), scale=jnp.asarray(scale),
                              config=J.NewtonConfig(**cfg), **kw)

    want = _jax(run_jax)

    def eval_fn(k):
        yy = torch.as_tensor(y) + h * k
        return torch.stack((yy[:, 1], torch.as_tensor(mu) * (1 - yy[:, 0] ** 2) * yy[:, 1]
                            - yy[:, 0]), -1)

    A = torch.as_tensor(M)
    kw = dict(M=A) if path == "M" else dict(operator=tref.batched_lu_factor(A))
    got = T.newton_solve(eval_fn, torch.zeros((4, 2), dtype=torch.float64),
                         scale=torch.as_tensor(scale), config=T.NewtonConfig(**cfg), **kw)
    for name in ("converged", "diverged", "n_iters"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name), name)
    assert got.n_evals == int(want.n_evals)
    np.testing.assert_allclose(got.k.numpy(), want.k, rtol=1e-12, atol=1e-12)
    assert (got.diverged.any() if case == "diverges" else got.converged.all())


def test_newton_solve_argument_checks():
    M = torch.eye(2, dtype=torch.float64).expand(1, 2, 2)
    k0, s = torch.ones((1, 2), dtype=torch.float64), torch.ones((1, 2), dtype=torch.float64)
    with pytest.raises(TypeError, match="exactly one"):
        T.newton_solve(lambda k: 0.5 * k, k0, M, s, operator=tref.batched_lu_factor(M))
    with pytest.raises(TypeError, match="exactly one"):
        T.newton_solve(lambda k: 0.5 * k, k0, scale=s)
    with pytest.raises(TypeError, match="requires scale"):
        T.newton_solve(lambda k: 0.5 * k, k0, M)
    with pytest.raises(TypeError):
        T.newton_solve(lambda k: 0.5 * k, k0, M, s, tol=1e-5)


def test_newton_config_is_frozen_and_hashable():
    cfg = T.NewtonConfig(max_iters=8)
    assert cfg == T.NewtonConfig() and hash(cfg) == hash(T.NewtonConfig())
    assert cfg.effective_slow_iters == 4 and T.NewtonConfig(max_iters=2).effective_slow_iters == 2
    assert T.NewtonConfig(max_iters=8, slow_iters=6).effective_slow_iters == 6
    with pytest.raises(AttributeError):
        cfg.tol = 1.0


# ---------------------------------------------- (e) whole solves against JAX


def vdp_t(t, y, mu):
    return torch.stack((y[..., 1], mu * (1 - y[..., 0] ** 2) * y[..., 1] - y[..., 0]), -1)


def vdp_j(t, y, mu):
    return jnp.stack((y[..., 1], mu * (1 - y[..., 0] ** 2) * y[..., 1] - y[..., 0]), -1)


def rob_t(t, y, args):
    y1, y2, y3 = y[..., 0], y[..., 1], y[..., 2]
    r1 = -0.04 * y1 + 1e4 * y2 * y3
    r3 = 3e7 * y2 * y2
    return torch.stack((r1, -r1 - r3, r3), -1)


def rob_j(t, y, args):
    y1, y2, y3 = y[..., 0], y[..., 1], y[..., 2]
    r1 = -0.04 * y1 + 1e4 * y2 * y3
    r3 = 3e7 * y2 * y2
    return jnp.stack((r1, -r1 - r3, r3), -1)


MU4 = np.array([1.0, 10.0, 100.0, 1000.0])
# implicit_euler is first order: under the PID controller it grinds (as in
# the JAX package's own tests), so its solves are capped at few steps and
# end in REACHED_MAX_STEPS on both sides.
PROBLEMS = {
    "vdp_mixed": (vdp_t, vdp_j, np.tile([[2.0, 0.0]], (4, 1)), MU4,
                  dict(t_start=0.0, t_end=0.5, rtol=1e-4, atol=1e-6)),
    "robertson": (rob_t, rob_j, np.tile([[1.0, 0.0, 0.0]], (2, 1)), None,
                  dict(t_start=0.0, t_end=100.0, rtol=1e-5, atol=1e-8)),
}


def _max_steps(method):
    return 60 if method == "implicit_euler" else 2000


@functools.lru_cache(maxsize=None)
def _jax_solve(problem, method, dense):
    _, fj, y0, args, kw = PROBLEMS[problem]
    te = np.linspace(kw["t_start"], kw["t_end"], 5) if dense else None

    def run():
        sol = J.solve_ivp(fj, jnp.asarray(y0), None if te is None else jnp.asarray(te),
                          args=None if args is None else jnp.asarray(args), method=method,
                          max_steps=_max_steps(method), **kw)
        return dict(ys=sol.ys, status=sol.status, **{k: sol.stats[k] for k in STATS})

    return _jax(run)


def _assert_matches_jax(sol, want):
    np.testing.assert_array_equal(sol.status.numpy(), want["status"])
    for k in STATS:
        np.testing.assert_array_equal(sol.stats[k].numpy(), want[k], err_msg=k)
    np.testing.assert_allclose(sol.ys.numpy(), want["ys"], rtol=1e-9, atol=1e-9)


def _port_solve(problem, method, dense, **extra):
    ft, _, y0, args, kw = PROBLEMS[problem]
    te = np.linspace(kw["t_start"], kw["t_end"], 5) if dense else None
    return T.solve_ivp(ft, y0, te, args=args, method=method, max_steps=_max_steps(method),
                       device="cpu", **kw, **extra)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("problem", sorted(PROBLEMS))
@pytest.mark.parametrize("method", IMPLICIT)
def test_float64_solve_matches_jax(method, problem, fused):
    sol = _port_solve(problem, method, dense=False, fused=fused)
    _assert_matches_jax(sol, _jax_solve(problem, method, False))
    if method != "implicit_euler":
        assert bool((sol.status == 0).all())
    if fused:
        assert torch.equal(sol.stats["n_fused_steps"], sol.stats["n_steps"])


@pytest.mark.parametrize("fused", [False, True])
def test_float64_dense_solve_matches_jax(fused):
    sol = _port_solve("vdp_mixed", "kvaerno5", dense=True, fused=fused)
    _assert_matches_jax(sol, _jax_solve("vdp_mixed", "kvaerno5", True))


@pytest.mark.parametrize("fused", [False, True])
def test_structured_state_solve_matches_jax(fused):
    """A dict state under kvaerno5: the Jacobian of the ravelled term comes
    from forward mode (``ravel_term`` builds no ``f_jac``), as in JAX."""
    y0 = {"x": np.full((3,), 2.0), "v": np.zeros((3,))}
    mu = np.array([1.0, 30.0, 300.0])

    def ft(t, y, args):
        return {"x": y["v"], "v": args * (1 - y["x"] ** 2) * y["v"] - y["x"]}

    kw = dict(t_start=0.0, t_end=0.3, method="kvaerno5", rtol=1e-5, atol=1e-7)

    def run():
        fj = J.ODETerm(lambda t, y, a: {"x": y["v"], "v": a * (1 - y["x"] ** 2) * y["v"]
                                        - y["x"]}, batched_args=True)
        sol = J.solve_ivp(fj, {k: jnp.asarray(v) for k, v in y0.items()}, None,
                          args=jnp.asarray(mu), **kw)
        return dict(ys=sol.ys, status=sol.status, **{k: sol.stats[k] for k in STATS})

    want = _jax(run)
    ft_term = T.ODETerm(ft, batched_args=True)
    sol = T.solve_ivp(ft_term, {k: torch.as_tensor(v) for k, v in y0.items()}, None, args=mu,
                      device="cpu", fused=fused, **kw)
    np.testing.assert_array_equal(sol.status.numpy(), want["status"])
    for k in STATS:
        np.testing.assert_array_equal(sol.stats[k].numpy(), want[k], err_msg=k)
    for name in ("x", "v"):
        np.testing.assert_allclose(sol.ys[name].numpy(), want["ys"][name], rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("fused", [False, True])
def test_event_solve_under_kvaerno5_matches_jax(fused):
    """A terminal event on x falling through 0 and a marker on v, over the
    mixed-stiffness Van der Pol batch."""
    kw = dict(t_start=0.0, t_end=3.0, method="kvaerno5", rtol=1e-6, atol=1e-8,
              max_steps=4000)
    mu = np.array([0.5, 1.0, 2.0, 20.0])
    y0 = np.tile([[2.0, 0.0]], (4, 1))

    def run():
        ev = (J.Event(lambda t, y, a: y[0], terminal=True, direction=-1.0),
              J.Event(lambda t, y, a: y[1] + 0.5))
        sol = J.solve_ivp(vdp_j, jnp.asarray(y0), None, args=jnp.asarray(mu), events=ev, **kw)
        return dict(ys=sol.ys, status=sol.status, event_t=sol.event_t, event_y=sol.event_y,
                    event_mask=sol.event_mask, n_events=sol.stats["n_events"],
                    **{k: sol.stats[k] for k in STATS})

    want = _jax(run)
    ev = (T.Event(lambda t, y, a: y[0], terminal=True, direction=-1.0),
          T.Event(lambda t, y, a: y[1] + 0.5))
    sol = T.solve_ivp(vdp_t, y0, None, args=mu, events=ev, device="cpu", fused=fused, **kw)
    np.testing.assert_array_equal(sol.status.numpy(), want["status"])
    np.testing.assert_array_equal(sol.event_mask.numpy(), want["event_mask"])
    for k in (*STATS, "n_events"):
        np.testing.assert_array_equal(sol.stats[k].numpy(), want[k], err_msg=k)
    for name in ("ys", "event_t", "event_y"):
        np.testing.assert_allclose(getattr(sol, name).numpy(), want[name], rtol=1e-9,
                                   atol=1e-9, equal_nan=True)
    assert bool((sol.status == 4).any())


# ------------------------------------------------ (f) fused == unfused, CPU


def _assert_bitwise(a, c):
    for name in ("ts", "ys", "status"):
        assert torch.equal(getattr(a, name), getattr(c, name)), name
    for k in STATS:
        assert torch.equal(a.stats[k], c.stats[k]), k
    assert torch.equal(c.stats["n_fused_steps"], c.stats["n_steps"])
    assert "n_fused_steps" not in a.stats
    assert not bool(c.stats["fused_fallback_reason"].any())


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("method", IMPLICIT)
def test_fused_equals_unfused_bitwise_vdp(method, dense):
    mu = np.array([1.0, 10.0, 100.0, 1000.0], np.float32)
    y0 = np.tile(np.array([[2.0, 0.0]], np.float32), (4, 1))
    te = np.linspace(0.0, 1.0, 5, dtype=np.float32) if dense else None
    kw = dict(t_start=0.0, t_end=1.0, args=mu, method=T.DiagonallyImplicitRK(method),
              rtol=1e-4, atol=1e-6, max_steps=_max_steps(method), device="cpu")
    _assert_bitwise(T.solve_ivp(vdp_t, y0, te, **kw), T.solve_ivp(vdp_t, y0, te, fused=True, **kw))


@pytest.mark.parametrize("method", ["trbdf2", "kvaerno5"])
def test_fused_equals_unfused_bitwise_robertson(method):
    y0 = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (3, 1))
    kw = dict(t_start=0.0, t_end=100.0, method=method, rtol=1e-4, atol=1e-8, device="cpu")
    a = T.solve_ivp(rob_t, y0, None, **kw)
    _assert_bitwise(a, T.solve_ivp(rob_t, y0, None, fused=True, **kw))
    assert bool((a.status == 0).all())


def test_fused_equals_unfused_on_the_starved_newton_reject_path():
    """max_iters=2 forces Newton failures: failed -> inf ratio -> reject,
    the same on both paths (n_steps > n_accepted)."""
    stepper = T.DiagonallyImplicitRK("kvaerno5", newton=T.NewtonConfig(max_iters=2))
    kw = dict(rtol=1e-5, atol=1e-6, max_steps=20_000)
    sk = dict(t_start=0.0, t_end=3.0, args=1000.0, device="cpu")
    y0 = np.array([[2.0, 0.0]], np.float32)
    a = T.AutoDiffAdjoint(stepper, **kw).solve(vdp_t, y0, None, **sk)
    c = T.AutoDiffAdjoint(stepper, fused=True, **kw).solve(vdp_t, y0, None, **sk)
    _assert_bitwise(a, c)
    assert bool((a.stats["n_steps"] > a.stats["n_accepted"]).all())


def test_fixed_controller_failure_is_not_success():
    """A Newton iteration that cannot converge is never committed, even by
    the always-accept FixedController, on either path."""
    stepper = T.DiagonallyImplicitRK("implicit_euler",
                                     newton=T.NewtonConfig(tol=1e-12, max_iters=1))
    kw = dict(max_steps=50, controller=T.FixedController())
    y0 = np.full((2, 1), 2.0, np.float32)
    sk = dict(t_start=0.0, t_end=1.0, dt0=0.25, device="cpu")
    a = T.AutoDiffAdjoint(stepper, **kw).solve(lambda t, y, a: -(y**3), y0, None, **sk)
    c = T.AutoDiffAdjoint(stepper, fused=True, **kw).solve(lambda t, y, a: -(y**3), y0, None,
                                                           **sk)
    _assert_bitwise(a, c)
    assert bool((c.status == T.Status.REACHED_MAX_STEPS.value).all())
    assert not bool(c.stats["n_accepted"].any())
    assert bool((c.ys == 2.0).all())


def test_fixed_controller_bitwise():
    kw = dict(max_steps=200, controller=T.FixedController())
    y0 = np.array([[2.0, 0.0]], np.float32)
    sk = dict(t_start=0.0, t_end=1.0, dt0=0.05, args=5.0, device="cpu")
    stepper = T.DiagonallyImplicitRK("trbdf2")
    _assert_bitwise(T.AutoDiffAdjoint(stepper, **kw).solve(vdp_t, y0, None, **sk),
                    T.AutoDiffAdjoint(stepper, fused=True, **kw).solve(vdp_t, y0, None, **sk))


def test_subclass_reports_unsupported_implicit():
    class MyDIRK(T.DiagonallyImplicitRK):
        pass

    kw = dict(t_start=0.0, t_end=0.2, args=10.0, device="cpu")
    y0 = np.array([[2.0, 0.0]])
    sol = T.solve_ivp(vdp_t, y0, None, method=MyDIRK("kvaerno3"), fused=True, **kw)
    assert int(sol.stats["fused_fallback_reason"][0]) == T.FusedFallbackReason.UNSUPPORTED_IMPLICIT
    assert int(T.FusedFallbackReason.UNSUPPORTED_IMPLICIT) == int(
        J.FusedFallbackReason.UNSUPPORTED_IMPLICIT) == 3
    assert "n_fused_steps" not in sol.stats
    plain = T.solve_ivp(vdp_t, y0, None, method="kvaerno3", **kw)
    assert torch.equal(sol.ys, plain.ys)


def test_polynomial_term_under_implicit_stepper_skips_fused_step_poly():
    term = T.polynomial_term(0.0, -50.0, 0.0, -1.0)  # stiff decay plus a cubic
    y0 = np.linspace(0.5, 1.5, 12).reshape(4, 3)
    kw = dict(t_start=0.0, t_end=1.0, method="kvaerno5", rtol=1e-6, atol=1e-8, device="cpu")
    with mock.patch.object(tref, "fused_step_poly", side_effect=AssertionError("poly")):
        c = T.solve_ivp(term, y0, None, fused=True, **kw)
    _assert_bitwise(T.solve_ivp(term, y0, None, **kw), c)


def test_coerce_and_exports():
    for name in IMPLICIT:
        st = T.AbstractStepper.coerce(name)
        assert type(st) is T.DiagonallyImplicitRK and st.tableau.name == name
    assert T.DiagonallyImplicitRK("kvaerno5") == T.DiagonallyImplicitRK()
    assert hash(T.DiagonallyImplicitRK()) == hash(T.DiagonallyImplicitRK("kvaerno5"))
    assert T.DiagonallyImplicitRK() != T.DiagonallyImplicitRK(
        newton=T.NewtonConfig(max_iters=3))
    with pytest.raises(ValueError, match="explicit"):
        T.DiagonallyImplicitRK("dopri5")
    with pytest.raises(ValueError, match="implicit stages"):
        T.ExplicitRK("kvaerno5")
    carry = T.DiagonallyImplicitRK().init_carry(None, None, torch.zeros(3, 2), None, None)
    assert isinstance(carry, T.DIRKCarry) and carry.jac.shape == (3, 2, 2)
    assert bool(carry.refresh.all())
    assert T.StepResult._fields[-3:] == ("carry", "solver_failed", "stats_aux")


# ----------------------------------------------------- (g) f_jac and kwargs


def test_f_jac_matches_vf_jac_and_drives_the_solver():
    def jac(t, y, mu):
        x, v = y[:, 0], y[:, 1]
        row0 = torch.stack((torch.zeros_like(x), torch.ones_like(x)), -1)
        row1 = torch.stack((-2 * mu * x * v - 1.0, mu * (1 - x**2)), -1)
        return torch.stack((row0, row1), -2)

    def jac_one(t, y, mu):
        return jac(t[None], y[None], mu)[0]

    rng = np.random.default_rng(0)
    y = torch.as_tensor(rng.standard_normal((5, 2)))
    t, mu = torch.zeros(5, dtype=torch.float64), torch.linspace(1.0, 100.0, 5,
                                                                 dtype=torch.float64)
    auto = T.ODETerm(vdp_t).vf_jac(t, y, mu)
    torch.testing.assert_close(T.ODETerm(vdp_t, f_jac=jac).vf_jac(t, y, mu), auto,
                               rtol=1e-12, atol=1e-12)
    unbatched = T.ODETerm(lambda ti, yi, a: vdp_t(ti, yi, a), batched=False,
                          f_jac=jac_one, batched_args=True)
    torch.testing.assert_close(unbatched.vf_jac(t, y, mu), auto, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(T.ODETerm(lambda ti, yi, a: vdp_t(ti, yi, a), batched=False,
                                         batched_args=True).vf_jac(t, y, mu), auto,
                               rtol=1e-12, atol=1e-12)
    term = T.ODETerm(vdp_t, f_jac=jac)
    assert T.as_term(term) is term
    kw = dict(t_start=0.0, t_end=0.5, args=MU4, method="kvaerno5", rtol=1e-4, atol=1e-6,
              device="cpu")
    y0 = np.tile([[2.0, 0.0]], (4, 1))
    with mock.patch.object(T.ODETerm, "vf_jac", autospec=True,
                           side_effect=T.ODETerm.vf_jac) as spy:
        a = T.solve_ivp(term, y0, None, **kw)
    assert spy.call_count > 0 and all(c.args[0] is term for c in spy.call_args_list)
    b = T.solve_ivp(vdp_t, y0, None, **kw)
    assert bool((a.status == 0).all())
    torch.testing.assert_close(a.ys, b.ys, rtol=1e-6, atol=1e-8)


def test_wrong_jacobian_costs_iterations():
    def f(t, y, args):
        return -5.0 * y

    kw = dict(t_start=0.0, t_end=1.0, method="kvaerno5", atol=1e-7, rtol=1e-6, device="cpu")
    good = T.solve_ivp(T.ODETerm(f), np.ones((1, 2)), None, **kw)
    bad = T.solve_ivp(T.ODETerm(f, f_jac=lambda t, y, a: torch.zeros(y.shape[0], 2, 2,
                                                                      dtype=y.dtype)),
                      np.ones((1, 2)), None, **kw)
    assert bool((bad.status == 0).all())
    assert int(bad.stats["n_newton_iters"][0]) > int(good.stats["n_newton_iters"][0])


def test_legacy_kwargs_warn_and_alias():
    with pytest.warns(DeprecationWarning, match="deprecated"):
        legacy = T.DiagonallyImplicitRK("kvaerno3", newton_tol=1e-4, max_newton_iters=11,
                                        slow_iters=3)
    modern = T.DiagonallyImplicitRK(
        "kvaerno3", newton=T.NewtonConfig(tol=1e-4, max_iters=11, slow_iters=3))
    assert legacy.newton == modern.newton and legacy == modern
    assert (legacy.newton_tol, legacy.max_newton_iters, legacy.slow_iters) == (1e-4, 11, 3)
    with pytest.warns(DeprecationWarning):
        st = T.DiagonallyImplicitRK("trbdf2", max_newton_iters=3)
    assert st.newton == T.NewtonConfig(max_iters=3) and st.newton_tol == T.NewtonConfig().tol
    with pytest.raises(TypeError, match="cannot combine"):
        T.DiagonallyImplicitRK("kvaerno3", newton=T.NewtonConfig(), newton_tol=1e-4)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        T.DiagonallyImplicitRK("kvaerno3", newton=T.NewtonConfig(max_iters=4))


def test_rejected_fused_step_keeps_f0_when_the_first_stage_is_implicit():
    """implicit_euler's K[0] is its implicit stage, not f(t, y): a rejected
    row must keep the f0 it came with (and the Hermite build read it), as on
    the unfused path.  The JAX package's fused step keeps K[0] here (ROADMAP
    C-7); the port passes f0 to ``fused_step``."""
    g = np.random.default_rng(0)
    b, f = 4, 3
    y, f0, K, f1 = (torch.as_tensor(g.standard_normal(s)) for s in ((b, f), (b, f), (1, b, f),
                                                                    (b, f)))
    cols = [torch.as_tensor(g.uniform(0.1, 1.0, b)) for _ in range(6)]
    running = torch.ones(b, dtype=torch.bool)
    failed = torch.tensor([True, False, True, False])
    out = tref.fused_step(y, K, f1, *cols[:4], running, *cols[4:], 1e-6, 1e-3,
                          b_sol=np.ones(1), b_err=np.zeros(1), ctrl=(), want_coeffs=True,
                          ctrl_mode="fixed", failed=failed, f0=f0)
    accept, f_out, coeffs = out[2], out[4], out[9]
    assert accept.tolist() == [False, True, False, True]
    assert torch.equal(f_out[failed], f0[failed]) and torch.equal(f_out[~failed], f1[~failed])
    want = tref.hermite_coeffs(y, out[0], f0, f1, cols[3])
    assert all(torch.equal(c, w) for c, w in zip(coeffs, want))
