"""The port's backsolve adjoint (``repro_torch.core.adjoint`` and
``BacksolveAdjoint``) against the JAX package's, on the CPU in float64.

Each case runs the same adjoint problem on both sides -- the forward solve,
then the augmented backward solve -- so the gradients agree to the solves'
rounding: within ``RTOL`` = 1e-8 relative to their size (the backward solve
is adaptive over 2bf + p entries, and float64 rounding in its error norm can
move a step size by an ulp).  Cases: ``make_adjoint_solve`` in ``joint``,
``per_instance`` and ``per_instance`` with ``batched_args`` rows; the
(b,)-row tolerances of joint mode; the time gradients; a tree of parameters;
``make_adjoint_solve_dense``; ``adjoint_backsolve_problem``; a ``kvaerno5``
backsolve (``tests/test_implicit.py``'s case); ``BacksolveAdjoint``'s memo,
its structured states and its refusal of events.  Marked ``reverse_diff``,
as their JAX counterparts are.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro.core.adjoint as JA  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.core.adjoint as TA  # noqa: E402

pytestmark = pytest.mark.reverse_diff

RTOL = 1e-8
A0 = np.array([[-0.5, 0.3], [-0.2, -0.8]])
Y0 = np.array([[1.0, 0.5], [0.3, -1.2], [2.0, 0.1]])


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def linear(t, y, A):
    return y @ A.T


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, np.abs(want).max()))


def _t(x, grad=True):
    return torch.tensor(np.asarray(x, np.float64), requires_grad=grad)


def _grads(loss, inputs):
    return [g.numpy() for g in torch.autograd.grad(loss, inputs)]


@pytest.mark.parametrize("mode", ["joint", "per_instance"])
def test_adjoint_matches_jax(mode):
    kw = dict(mode=mode, rtol=1e-8, atol=1e-8)
    with jax.enable_x64(True):
        jsolve = JA.make_adjoint_solve(linear, **kw)
        jg = jax.grad(lambda y0, A: jnp.sum(jsolve(y0, 0.0, 1.0, A) ** 2), argnums=(0, 1))(
            jnp.asarray(Y0), jnp.asarray(A0))
    y0, A = _t(Y0), _t(A0)
    solve = TA.make_adjoint_solve(linear, device="cpu", **kw)
    tg = _grads(torch.sum(solve(y0, 0.0, 1.0, A) ** 2), (y0, A))
    _close(tg[0], jg[0])
    _close(tg[1], jg[1])


def test_time_gradients_match_jax():
    """dL/dt_start and dL/dt_end, per instance (the (b,) times)."""
    t0, t1 = np.zeros(3), np.array([1.0, 0.8, 1.2])
    with jax.enable_x64(True):
        jsolve = JA.make_adjoint_solve(linear, mode="per_instance", rtol=1e-9, atol=1e-9)
        jg = jax.grad(lambda a, b: jnp.sum(jnp.sin(jsolve(jnp.asarray(Y0), a, b,
                                                          jnp.asarray(A0)))),
                      argnums=(0, 1))(jnp.asarray(t0), jnp.asarray(t1))
    ts, te = _t(t0), _t(t1)
    solve = TA.make_adjoint_solve(linear, mode="per_instance", rtol=1e-9, atol=1e-9,
                                  device="cpu")
    tg = _grads(torch.sum(torch.sin(solve(_t(Y0, False), ts, te, _t(A0, False)))), (ts, te))
    _close(tg[0], jg[0])
    _close(tg[1], jg[1])
    # And a scalar end time against the finite difference, as the JAX test.
    joint = TA.make_adjoint_solve(linear, rtol=1e-9, atol=1e-9, device="cpu")
    t_end = _t(1.0)
    g = _grads(torch.sum(joint(_t(Y0, False), 0.0, t_end, _t(A0, False)) ** 2), (t_end,))[0]
    with torch.no_grad():
        fd = [torch.sum(joint(_t(Y0, False), 0.0, 1.0 + s * 1e-3, _t(A0, False)) ** 2)
              for s in (1, -1)]
    np.testing.assert_allclose(float(g), float((fd[0] - fd[1]) / 2e-3), rtol=1e-2)


def test_tree_params_match_jax():
    p = {"w": np.eye(2) * 0.5, "v": np.eye(2) * -0.3}
    kw = dict(mode="joint", rtol=1e-7, atol=1e-9)
    with jax.enable_x64(True):
        jsolve = JA.make_adjoint_solve(lambda t, y, q: jnp.tanh(y @ q["w"]) @ q["v"], **kw)
        jg = jax.grad(lambda q: jnp.sum(jsolve(jnp.asarray(Y0), 0.0, 1.0, q) ** 2))(
            {k: jnp.asarray(v) for k, v in p.items()})
    tp = {k: _t(v) for k, v in p.items()}
    solve = TA.make_adjoint_solve(lambda t, y, q: torch.tanh(y @ q["w"]) @ q["v"],
                                  device="cpu", **kw)
    tg = _grads(torch.sum(solve(_t(Y0, False), 0.0, 1.0, tp) ** 2), list(tp.values()))
    for got, name in zip(tg, tp):
        _close(got, jg[name])


@pytest.mark.parametrize("mode", ["per_instance", "joint"])
def test_batched_args_rows(mode):
    """Every params leaf carries the batch and instance i owns row i: one
    gradient row per instance, against JAX and the closed form
    y1 = y0 exp(-r)."""
    y0 = np.array([[1.0, 0.5], [0.3, 1.2], [2.0, 0.1]])
    rates = np.array([[0.5, 2.0], [1.3, 0.7], [0.9, 1.6]])
    kw = dict(mode=mode, rtol=1e-9, atol=1e-10, batched_args=mode == "per_instance")
    with jax.enable_x64(True):
        jsolve = JA.make_adjoint_solve(lambda t, y, r: -r * y, **kw)
        jg = jax.grad(lambda a, r: jnp.sum(jsolve(a, 0.0, 1.0, r)), argnums=(0, 1))(
            jnp.asarray(y0), jnp.asarray(rates))
    ty, tr = _t(y0), _t(rates)
    solve = TA.make_adjoint_solve(lambda t, y, r: -r * y, device="cpu", **kw)
    tg = _grads(torch.sum(solve(ty, 0.0, 1.0, tr)), (ty, tr))
    assert tg[1].shape == rates.shape
    _close(tg[0], jg[0])
    _close(tg[1], jg[1])
    np.testing.assert_allclose(tg[1], -y0 * np.exp(-rates), rtol=1e-6)


def test_joint_tolerance_rows_collapse_to_the_strictest():
    """(b,) tolerances reach the joint backward solve, one instance: they
    collapse to the strictest row, as in JAX."""
    rows = dict(rtol=np.array([1e-7, 1e-8, 1e-6]), atol=np.array([1e-9, 1e-8, 1e-9]))
    with jax.enable_x64(True):
        jsolve = JA.make_adjoint_solve(linear, mode="joint",
                                       **{k: jnp.asarray(v) for k, v in rows.items()})
        jg = jax.grad(lambda A: jnp.sum(jsolve(jnp.asarray(Y0), 0.0, 1.0, A) ** 2))(
            jnp.asarray(A0))
    A = _t(A0)
    solve = TA.make_adjoint_solve(linear, mode="joint", device="cpu", **rows)
    g = _grads(torch.sum(solve(_t(Y0, False), 0.0, 1.0, A) ** 2), (A,))[0]
    _close(g, jg)
    # The backward solve is the scalar-tolerance one at the strictest row.
    with torch.no_grad():
        y1 = solve(_t(Y0, False), 0.0, 1.0, A)
    problem = TA.adjoint_backsolve_problem(linear, y1, 2 * y1, torch.zeros(3),
                                           torch.ones(3), A.detach())
    sol = T.solve_ivp(problem[0], problem[1], None, t_start=problem[2], t_end=problem[3],
                      rtol=1e-8, atol=1e-9, device="cpu")
    np.testing.assert_allclose(g.ravel(), sol.ys[0, 12:].numpy(), rtol=1e-12)


def test_dense_adjoint_matches_jax():
    t_eval = np.linspace(0.0, 1.5, 6)
    w = np.arange(1.0, 7.0)[None, :, None]
    with jax.enable_x64(True):
        jsolve = JA.make_adjoint_solve_dense(linear, rtol=1e-8, atol=1e-8)
        jg = jax.grad(lambda y0, A: jnp.sum(jnp.sin(jsolve(y0, jnp.asarray(t_eval), A)) * w),
                      argnums=(0, 1))(jnp.asarray(Y0), jnp.asarray(A0))
    y0, A = _t(Y0), _t(A0)
    solve = TA.make_adjoint_solve_dense(linear, rtol=1e-8, atol=1e-8, device="cpu")
    tg = _grads(torch.sum(torch.sin(solve(y0, t_eval, A)) * torch.as_tensor(w)), (y0, A))
    _close(tg[0], jg[0])
    _close(tg[1], jg[1])


@pytest.mark.parametrize("mode", ["joint", "per_instance"])
def test_backsolve_problem_matches_jax(mode):
    """The augmented backward IVP itself: the same initial state, range and
    dynamics, so the same solve with the same statistics."""
    y1 = np.array([[0.4, 0.1], [0.2, -0.5], [0.9, 0.3]])
    g = np.array([[1.0, -1.0], [0.5, 0.5], [2.0, 0.0]])
    with jax.enable_x64(True):
        jp = JA.adjoint_backsolve_problem(linear, jnp.asarray(y1), jnp.asarray(g),
                                          jnp.zeros(3), jnp.ones(3), jnp.asarray(A0), mode=mode)
        js = J.solve_ivp(jp[0], jp[1], None, t_start=jp[2], t_end=jp[3], rtol=1e-8, atol=1e-8)
        jys, jsteps = np.asarray(js.ys), np.asarray(js.stats["n_steps"])
    tp = TA.adjoint_backsolve_problem(linear, torch.tensor(y1), torch.tensor(g),
                                      torch.zeros(3, dtype=torch.float64),
                                      torch.ones(3, dtype=torch.float64), torch.tensor(A0),
                                      mode=mode)
    np.testing.assert_array_equal(tp[1].numpy(), np.asarray(jp[1]))
    ts = T.solve_ivp(tp[0], tp[1], None, t_start=tp[2], t_end=tp[3], rtol=1e-8, atol=1e-8,
                     device="cpu")
    np.testing.assert_array_equal(ts.stats["n_steps"].numpy(), jsteps)
    np.testing.assert_allclose(ts.ys.numpy(), jys, rtol=1e-9, atol=1e-12)


def test_kvaerno5_backsolve_matches_jax():
    """``tests/test_implicit.py``'s case with kvaerno5: the forward and the
    backward solves run the implicit stepper; d/da sum(4 exp(a)) = 4 exp(a)."""
    a0 = -1.5
    with jax.enable_x64(True):
        jdrv = J.BacksolveAdjoint(J.DiagonallyImplicitRK("kvaerno5"), rtol=1e-7, atol=1e-8)
        jg = jax.grad(lambda a: jnp.sum(jdrv.solve(lambda t, y, a_: a_ * y, jnp.ones((2, 2)),
                                                   t_start=0.0, t_end=1.0, args=a)))(a0)
    drv = T.BacksolveAdjoint(T.DiagonallyImplicitRK("kvaerno5"), rtol=1e-7, atol=1e-8)
    a = _t(a0)
    y1 = drv.solve(lambda t, y, a_: a_ * y, torch.ones(2, 2, dtype=torch.float64),
                   t_start=0.0, t_end=1.0, args=a, device="cpu")
    g = _grads(torch.sum(y1), (a,))[0]
    _close(g, jg)
    np.testing.assert_allclose(float(g), 4.0 * np.exp(a0), rtol=1e-3)


class TestBacksolveDriver:
    def test_memoizes_the_closure(self):
        """Repeated solves with the same vector field reuse one closure; a
        different vector field is another entry."""
        calls = []

        def vf(t, y, args):  # a flat batch, or one instance of a structure
            return torch.utils._pytree.tree_map(lambda x: -x * args, y)

        drv = T.BacksolveAdjoint(T.Stepper("dopri5"), rtol=1e-6, atol=1e-8)
        y0 = torch.ones(2, 3, dtype=torch.float64)
        args = torch.tensor(0.7, dtype=torch.float64)
        with pytest.MonkeyPatch.context() as mp:
            real = TA.make_adjoint_solve
            mp.setattr(TA, "make_adjoint_solve", lambda *a, **k: calls.append(1) or real(*a, **k))
            first = drv.solve(vf, y0, t_start=0.0, t_end=1.0, args=args, device="cpu")
            closure = next(iter(drv._solve_memo.values()))
            for _ in range(3):
                again = drv.solve(vf, y0, t_start=0.0, t_end=1.0, args=args, device="cpu")
            assert len(calls) == 1 and len(drv._solve_memo) == 1
            assert next(iter(drv._solve_memo.values())) is closure
            torch.testing.assert_close(first, again, rtol=0, atol=0)
            drv.solve(lambda t, y, a: -2.0 * y * a, y0, t_start=0.0, t_end=1.0, args=args,
                      device="cpu")
            assert len(calls) == 2 and len(drv._solve_memo) == 2
            drv.solve(vf, {"a": y0[:, :1], "b": y0[:, 1:]}, t_start=0.0, t_end=1.0,
                      args=args, device="cpu")
            assert len(drv._solve_memo) == 3, "another state structure is another entry"

    def test_structured_state_against_jax(self):
        """A dict state comes back in the caller's structure; its gradients
        match JAX's (JAX orders dict leaves by key: give the keys in order)."""
        y0 = {"h": np.array([[1.0], [0.5]]), "v": np.array([[0.2], [-0.3]])}

        def dyn_j(t, y, k):
            return {"h": y["v"], "v": -k * y["h"]}

        def dyn_t(t, y, k):
            return {"v": -k * y["h"], "h": y["v"]}

        with jax.enable_x64(True):
            jdrv = J.BacksolveAdjoint("dopri5", rtol=1e-8, atol=1e-9)
            jg = jax.grad(lambda y, k: jnp.sum(jdrv.solve(dyn_j, y, t_start=0.0, t_end=1.0,
                                                          args=k)["h"] ** 2),
                          argnums=(0, 1))({k: jnp.asarray(v) for k, v in y0.items()}, 2.0)
        ty = {k: _t(v) for k, v in y0.items()}
        k = _t(2.0)
        drv = T.BacksolveAdjoint("dopri5", rtol=1e-8, atol=1e-9)
        out = drv.solve(dyn_t, ty, t_start=0.0, t_end=1.0, args=k, device="cpu")
        assert set(out) == {"h", "v"} and out["h"].shape == (2, 1)
        tg = _grads(torch.sum(out["h"] ** 2), (ty["h"], ty["v"], k))
        _close(tg[0], jg[0]["h"])
        _close(tg[1], jg[0]["v"])
        _close(tg[2], jg[1])

    def test_refuses_events(self):
        ev = T.Event(lambda t, y, args: y[0], terminal=True)
        with pytest.raises(ValueError, match="does not support events"):
            T.BacksolveAdjoint("tsit5", events=ev)

    def test_without_a_card_it_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.BacksolveAdjoint().solve(linear, Y0, t_start=0.0, t_end=1.0, args=A0)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TA.make_adjoint_solve(linear)(Y0, 0.0, 1.0, A0)
