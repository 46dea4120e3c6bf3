"""Reverse-mode gradients of the port: the four backwards of
``repro_torch.kernels.autograd`` and ``ScanAdjoint`` / ``solve_ivp_scan``,
on the CPU.

- (a) Each Function's backward against ``torch.autograd.grad`` of the plain
  op in ``kernels/ref.py`` on the same inputs
  (``repro_torch.tools.grad_checks``: ``dense_checks``' widths, the three
  tolerance shapes, every mask kind, the window, a row whose error is zero,
  ties and zeros under ``abs``), at ``step_checks.tolerance`` (1e-5 float32,
  1e-12 float64) with the same NaN entries; and ``torch.autograd.gradcheck``
  of each Function in float64.  Here the CUDA kernel is stood in by its
  plain op under no grad (the ``card`` fixture): the Function's forward only
  launches the kernel, so the backward is what is tested; the card tests
  hold the real kernels.
- (b) ``solve_ivp_scan`` gradients against ``jax.grad`` of the JAX
  package's ``solve_ivp_scan`` in float64: flat, structured, backward in
  time with dense output, the MLP of ``full_width_train`` at its reduced
  float64 widths, and ``checkpoint_every`` with a remainder block (bitwise
  equal to no checkpoint).  Step counts are equal and gradients agree to
  1e-9 relative to their size (``GRAD_RTOL``): both sides differentiate the
  same expressions, and float64 rounding compounds over a few hundred
  operations per step.
- (c) The same solves through the Functions (``card``) against the plain
  CPU solve within 1e-12, with exact kernel launch counts, checkpoint
  recompute included; ``AutoDiffAdjoint`` too, and the windowed dense output.
- (d) ``fused=True``, ``events=`` and an implicit method differentiate on the
  CPU; the scan-driver case of ``tests/test_events.py``.

All marked ``reverse_diff``, as their JAX counterparts are.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import autograd as AG  # noqa: E402
from repro_torch.kernels import cuda_impl, ops, ref  # noqa: E402
from repro_torch.tools import dense_checks, grad_checks, workloads  # noqa: E402

pytestmark = pytest.mark.reverse_diff

GRAD_RTOL = 1e-9
A0 = np.array([[-0.5, 0.3], [-0.2, -0.8]])
Y0 = np.array([[1.0, 0.5], [0.3, -1.2], [2.0, 0.1]])
TE = np.linspace(0.0, 1.5, 6)
WEIGHTS = np.arange(1.0, 7.0)[None, :, None]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def card(monkeypatch):
    """The four explicit-path ops take their CUDA route on CPU tensors, each
    kernel stood in by its plain op under no grad (``interp_eval`` writing
    into the buffer it is given, as the kernel does) and counted in
    ``launches`` as the wrappers count."""
    def stand_in(name):
        def launch(*a, **kw):
            with torch.no_grad():
                if name == "interp_eval":
                    coeffs, x, mask, out, cursor = a[:5]
                    res = out.copy_(grad_checks.plain(name)(coeffs, x, mask, out, cursor))
                else:
                    res = getattr(ref, name)(*a, **kw)
            cuda_impl.launches[name] += 1
            return res
        return launch

    for name in grad_checks.OPS:
        monkeypatch.setattr(cuda_impl, name, stand_in(name))
    monkeypatch.setattr(ops, "_on_cuda", lambda name, t: name in grad_checks.OPS)
    saved = dict(cuda_impl.launches)
    cuda_impl.launches.update(dict.fromkeys(cuda_impl.launches, 0))
    yield cuda_impl.launches
    cuda_impl.launches.update(saved)


# ------------------------------------------------------------ (a) backwards


@pytest.mark.parametrize("op", grad_checks.OPS)
@pytest.mark.parametrize("f", dense_checks.ERROR_NORM_WIDTHS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_backward_matches_plain(card, dtype, f, op):
    tdtype = torch.float32 if dtype == np.float32 else torch.float64
    for case in grad_checks.cases(37, f, 9, dtype, seed=f):
        if case["op"] != op:
            continue
        want = grad_checks.case_grads(case, grad_checks.plain(op), "cpu")
        got = grad_checks.case_grads(case, grad_checks.function(op), "cpu")
        grad_checks.hold(f"{op}[{case['label']}]", got, want, tdtype)


def _gradcheck_inputs(op, seed=0):
    g = torch.Generator().manual_seed(seed)
    b, f, n = 3, 5, 6

    def r(*s):
        return torch.randn(*s, generator=g, dtype=torch.float64).requires_grad_()

    c = np.random.default_rng(seed).standard_normal(7)
    if op == "stage_accum":
        return (lambda y, dt, K: AG.stage_accum(y, dt, K, c[:3])), (r(b, f), r(b), r(3, b, f))
    if op == "fused_update":
        return (lambda y, K, dt: AG.fused_update(y, K, dt, c[:4], c[3:])), (r(b, f), r(4, b, f),
                                                                           r(b))
    if op == "error_norm":
        atol = (torch.rand(b, generator=g, dtype=torch.float64) + 0.1).requires_grad_()
        rtol = torch.rand(b, f, generator=g, dtype=torch.float64).requires_grad_()
        return AG.error_norm, (r(b, f), r(b, f), r(b, f), atol, rtol)
    mask = torch.rand(b, n, generator=g) < 0.5
    x = torch.rand(b, n, generator=g, dtype=torch.float64).requires_grad_()
    inputs = (x, r(b, n, f), *(r(b, f) for _ in range(4)))
    if op == "interp_eval":
        return (lambda x, out, *cs: AG.interp_eval(cs, x, mask, out)), inputs
    cursor = torch.tensor([0, 2, 1])
    return (lambda x, out, *cs: AG.interp_eval(cs, x[:, :3], mask[:, :3], out, cursor)), inputs


@pytest.mark.parametrize("op", [*grad_checks.OPS, "interp_eval_window"])
def test_gradcheck(card, op):
    fn, inputs = _gradcheck_inputs(op)
    assert torch.autograd.gradcheck(fn, inputs)


def test_zero_error_row_is_nan_as_plain(card):
    """At ratio 0 autograd of the plain op computes 0 * inf: the Function's
    backward gives the same NaN row, and the other rows stay finite."""
    rng = np.random.default_rng(3)
    err, y0, y1 = (torch.tensor(rng.standard_normal((4, 6)), requires_grad=True)
                   for _ in range(3))
    with torch.no_grad():
        err[2] = 0.0
    w = torch.tensor([1.0, 1.0, 0.0, 1.0], dtype=torch.float64)
    want = torch.autograd.grad((ref.error_norm(err, y0, y1, 1e-6, 1e-3) * w).sum(), err)[0]
    got = torch.autograd.grad((AG.error_norm(err, y0, y1, 1e-6, 1e-3) * w).sum(), err)[0]
    assert bool(want[2].isnan().all()) and bool(torch.isfinite(want[[0, 1, 3]]).all())
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12, equal_nan=True)


def test_ops_take_the_functions_only_under_autograd(card):
    """On the card route, grad on and an input that requires grad: the
    Function (and ``interp_eval`` writes a copy); otherwise the kernel
    itself, and ``interp_eval`` writes in place."""
    g = torch.Generator().manual_seed(0)
    coeffs = tuple(torch.randn(2, 3, generator=g, dtype=torch.float64) for _ in range(4))
    x = torch.rand(2, 4, generator=g, dtype=torch.float64, requires_grad=True)
    mask = torch.ones(2, 4, dtype=torch.bool)
    out = torch.zeros(2, 4, 3, dtype=torch.float64)
    res = ops.interp_eval(coeffs, x, mask, out)
    assert type(res.grad_fn).__name__ == "InterpEvalBackward"
    assert not out.any() and res.abs().sum() > 0
    with torch.no_grad():
        res = ops.interp_eval(coeffs, x, mask, out)
    assert res is out and out.abs().sum() > 0
    y = torch.ones(2, 3, dtype=torch.float64, requires_grad=True)
    dt, K = torch.ones(2, dtype=torch.float64), torch.ones(1, 2, 3, dtype=torch.float64)
    assert type(ops.stage_accum(y, dt, K, [0.5]).grad_fn).__name__ == "StageAccumBackward"
    assert ops.stage_accum(y.detach(), dt, K, [0.5]).grad_fn is None
    assert card["stage_accum"] == 2 and card["interp_eval"] == 2


# ------------------------------------------------------ (b) against JAX


def _jax_linear(t, y, A):
    return y @ A.T


def _torch_linear(t, y, A):
    return y @ A.T


def _jax_scan_grads(vf, y0, te, args, loss, **kw):
    """``jax.grad`` of ``loss(ys)`` through the JAX ``solve_ivp_scan``, in
    float64, w.r.t. y0 and args; and the solve's ``n_steps``."""
    with jax.enable_x64(True):
        y0j = jax.tree_util.tree_map(jnp.asarray, y0)
        argsj = jax.tree_util.tree_map(jnp.asarray, args)

        def f(y0_, args_):
            return loss(J.solve_ivp_scan(vf, y0_, te, args=args_, **kw).ys)

        gy, ga = jax.grad(f, argnums=(0, 1))(y0j, argsj)
        steps = J.solve_ivp_scan(vf, y0j, te, args=argsj, **kw).stats["n_steps"]
        return (jax.tree_util.tree_map(np.asarray, gy), jax.tree_util.tree_map(np.asarray, ga),
                np.asarray(steps))


def _torch_scan_grads(vf, y0, te, args, loss, **kw):
    y0t = convert.from_numpy(y0, "cpu")
    argst = convert.from_numpy(args, "cpu")
    leaves = [x.requires_grad_() for x in torch.utils._pytree.tree_leaves((y0t, argst))]
    sol = T.solve_ivp_scan(vf, y0t, te, args=argst, device="cpu", **kw)
    grads = torch.autograd.grad(loss(sol.ys), leaves)
    ys = torch.utils._pytree.tree_map(lambda x: x.detach().numpy(), sol.ys)
    return [g.numpy() for g in grads], sol.stats["n_steps"].numpy(), ys


def _close(got, want):
    got = np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * max(1.0, float(np.abs(want).max())))


def _vdp_jax(t, y, mu):
    x, v = y["x"], y["v"]
    return {"x": v, "v": mu * (1 - x**2) * v - x}


def _vdp_torch(t, y, mu):
    x, v = y["x"], y["v"]
    return {"x": v, "v": mu * (1 - x**2) * v - x}


class TestScanAgainstJax:
    KW = dict(rtol=1e-8, atol=1e-8, max_steps=128)

    def test_flat_final_state(self):
        jg = _jax_scan_grads(_jax_linear, Y0, None, A0, lambda ys: jnp.sum(ys**2),
                             t_start=0.0, t_end=1.0, **self.KW)
        tg, steps, _ = _torch_scan_grads(_torch_linear, Y0, None, A0,
                                         lambda ys: torch.sum(ys**2), t_start=0.0, t_end=1.0,
                                         **self.KW)
        np.testing.assert_array_equal(steps, jg[2])
        _close(tg[0], jg[0])
        _close(tg[1], jg[1])

    @pytest.mark.parametrize("span", ["forward", "backward"])
    def test_flat_dense(self, span):
        te = TE if span == "forward" else TE[::-1].copy()
        jg = _jax_scan_grads(_jax_linear, Y0, te, A0,
                             lambda ys: jnp.sum(jnp.sin(ys) * WEIGHTS), **self.KW)
        tg, steps, _ = _torch_scan_grads(_torch_linear, Y0, te, A0,
                                         lambda ys: torch.sum(torch.sin(ys) * torch.as_tensor(
                                             WEIGHTS)), **self.KW)
        np.testing.assert_array_equal(steps, jg[2])
        _close(tg[0], jg[0])
        _close(tg[1], jg[1])

    @pytest.mark.parametrize("order", ["xv", "vx"])
    def test_structured_state(self, order):
        """Per-instance dict state: the vector field sees one instance, and
        builds its derivative in either key order.  No state entry is 0:
        there the frameworks' ``abs`` differ (torch's abs'(0) = 0, JAX's 1,
        ROADMAP C's rule), and the error norm's max(|y0|, |y1|) carries it."""
        x, v = np.array([[2.0], [1.5], [-1.0]]), np.array([[0.1], [0.5], [0.2]])
        y0 = {"x": x, "v": v} if order == "xv" else {"v": v, "x": x}
        mu = np.float64(2.0)
        te = np.linspace(0.0, 2.0, 5)

        def jloss(ys):
            return jnp.sum(ys["x"] ** 2) + jnp.sum(jnp.cos(ys["v"]))

        def tloss(ys):
            return torch.sum(ys["x"] ** 2) + torch.sum(torch.cos(ys["v"]))

        kw = dict(rtol=1e-7, atol=1e-9, max_steps=200)
        jg = _jax_scan_grads(_vdp_jax, y0, te, mu, jloss, **kw)
        tg, steps, _ = _torch_scan_grads(_vdp_torch, y0, te, mu, tloss, **kw)
        np.testing.assert_array_equal(steps, jg[2])
        # torch's leaves of a dict come in insertion order, JAX's by key.
        for got, name in zip(tg, y0):
            _close(got, jg[0][name])
        _close(tg[2], jg[1])

    def test_reduced_train_mlp(self):
        """``full_width_train``'s MLP at its reduced float64 widths: the MSE
        against the seed-1 target, w.r.t. y0 and every weight."""
        vf, y0, te, kw, target = workloads.full_width_train("cpu", reduced=True)
        weights = {k: v.detach().numpy() for k, v in kw["args"].items()}
        tgt = target.numpy()

        def jmlp(t, y, p):
            return jnp.tanh(y @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]

        skw = dict(rtol=kw["rtol"], atol=kw["atol"], max_steps=workloads.TRAIN["max_steps"])
        jg = _jax_scan_grads(jmlp, y0, te, weights, lambda ys: jnp.mean((ys - tgt) ** 2),
                             **skw)
        tg, steps, _ = _torch_scan_grads(vf, y0, te, weights,
                                         lambda ys: workloads.mse(ys, target), **skw)
        np.testing.assert_array_equal(steps, jg[2])
        assert steps.max() < workloads.TRAIN["max_steps"]
        _close(tg[0], jg[0])
        for got, name in zip(tg[1:], weights):
            _close(got, jg[1][name])

    def test_checkpoint_tail_bitwise(self):
        """max_steps % checkpoint_every != 0: the remainder block runs inside
        its checkpoint, and values and gradients equal the plain loop's
        bitwise; both match JAX's checkpointed scan."""
        kw = dict(max_steps=50, rtol=1e-6, atol=1e-8)
        assert 50 % 16 != 0
        runs = [_torch_scan_grads(_torch_linear, Y0, TE, A0, lambda ys: torch.sum(ys**2),
                                  checkpoint_every=every, **kw) for every in (0, 16)]
        for a, c in zip(runs[0][0], runs[1][0]):
            assert np.array_equal(a, c)
        assert np.array_equal(runs[0][2], runs[1][2])
        jg = _jax_scan_grads(_jax_linear, Y0, TE, A0, lambda ys: jnp.sum(ys**2),
                             checkpoint_every=16, **kw)
        np.testing.assert_array_equal(runs[1][1], jg[2])
        _close(runs[1][0][1], jg[1])


def test_solve_ivp_scan_signature_and_masked_steps():
    """JAX's defaults (``max_steps=256``); the loop runs every step, so the
    iteration counter reaches max_steps only while a row runs, and the stats
    stop where the rows stopped."""
    sol = T.solve_ivp_scan(_torch_linear, Y0, TE, args=torch.as_tensor(A0), device="cpu")
    steps = sol.stats["n_steps"].numpy()
    assert T.ScanAdjoint().max_steps == 256 and steps.max() < 256
    with jax.enable_x64(True):
        jsol = J.solve_ivp_scan(_jax_linear, jnp.asarray(Y0), jnp.asarray(TE),
                                args=jnp.asarray(A0))
    for k in ("n_steps", "n_accepted", "n_f_evals", "n_initialized"):
        np.testing.assert_array_equal(sol.stats[k].numpy(), np.asarray(jsol.stats[k]), k)
    np.testing.assert_allclose(sol.ys.numpy(), np.asarray(jsol.ys), rtol=1e-9, atol=1e-12)


# ------------------------------------------- (c) through the Functions


def _scan_run(driver, te=TE, dense_window=0):
    y0 = torch.tensor(Y0, requires_grad=True)
    A = torch.tensor(A0, requires_grad=True)
    sol = driver.solve(_torch_linear, y0, te, args=A, device="cpu")
    loss = torch.sum(torch.sin(sol.ys) * torch.as_tensor(WEIGHTS))
    return sol, torch.autograd.grad(loss, (y0, A))


@pytest.mark.parametrize("every", [0, 16])
def test_scan_through_functions_matches_plain(card, every):
    kw = dict(rtol=1e-8, atol=1e-8, max_steps=50, checkpoint_every=every)
    sol, grads = _scan_run(T.ScanAdjoint(**kw))
    fwd = sum(card.values())
    want_fwd = dict.fromkeys(card, 0)
    want_fwd.update(stage_accum=6 * 50, fused_update=50, error_norm=50, interp_eval=50)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "_on_cuda", lambda name, t: False)
        plain_sol, plain = _scan_run(T.ScanAdjoint(**kw))
    # Each checkpointed block is run once more in the backward pass.
    assert dict(card) == {k: v * (2 if every else 1) for k, v in want_fwd.items()}
    assert fwd == sum(want_fwd.values()) * (2 if every else 1)
    np.testing.assert_array_equal(sol.ys.detach().numpy(), plain_sol.ys.detach().numpy())
    np.testing.assert_array_equal(sol.stats["n_steps"].numpy(),
                                  plain_sol.stats["n_steps"].numpy())
    for g, p in zip(grads, plain):
        torch.testing.assert_close(g, p, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("driver", ["AutoDiffAdjoint", "ScanAdjoint-window"])
def test_other_paths_through_functions(card, driver):
    """``AutoDiffAdjoint`` (no other change) and the windowed dense output
    (``interp_eval``'s cursor form) differentiate through the Functions."""
    kw = dict(rtol=1e-8, atol=1e-8, max_steps=64)
    make = (lambda: T.AutoDiffAdjoint(**kw)) if driver == "AutoDiffAdjoint" else (
        lambda: T.ScanAdjoint(dense_window=2, **kw))
    sol, grads = _scan_run(make())
    assert card["interp_eval"] > 0 and card["error_norm"] > 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "_on_cuda", lambda name, t: False)
        _, plain = _scan_run(make())
    for g, p in zip(grads, plain):
        torch.testing.assert_close(g, p, rtol=1e-12, atol=1e-12)


# ------------------------------------------ (d) the other paths, on the CPU


@pytest.mark.parametrize("variant", ["fused", "events", "kvaerno5"])
def test_cpu_paths_differentiate(variant):
    """On the CPU the plain ops' autograd differentiates the paths whose
    kernels have no backward on the card (ROADMAP A-18): fused equals
    unfused; the events and the implicit solve match JAX's gradients."""
    if variant == "fused":
        grads = [_scan_run(T.ScanAdjoint(rtol=1e-8, atol=1e-8, max_steps=50, fused=fused))[1]
                 for fused in (False, True)]
        for g, p in zip(*grads):
            torch.testing.assert_close(g, p, rtol=1e-12, atol=1e-12)
        return
    if variant == "events":
        kw = dict(events=T.Event(lambda t, y, args: y[0] - 0.5, terminal=False), rtol=1e-8,
                  atol=1e-8, max_steps=64)
        jkw = dict(kw, events=J.Event(lambda t, y, args: y[0] - 0.5, terminal=False))
    else:
        kw = dict(method="kvaerno5", rtol=1e-7, atol=1e-9, max_steps=64)
    tg, steps, _ = _torch_scan_grads(_torch_linear, Y0, TE, A0,
                                     lambda ys: torch.sum(torch.sin(ys) * torch.as_tensor(
                                         WEIGHTS)), **kw)
    if variant == "events":
        jg = _jax_scan_grads(_jax_linear, Y0, TE, A0,
                             lambda ys: jnp.sum(jnp.sin(ys) * WEIGHTS), **jkw)
        np.testing.assert_array_equal(steps, jg[2])
        _close(tg[0], jg[0])
        _close(tg[1], jg[1])
        return
    # JAX cannot reverse-differentiate its Newton loop (a while_loop): hold
    # the step counts to its forward solve, and the gradient to JAX's dopri5
    # gradient at 1e-11, within the kvaerno5 solve's own error.
    with jax.enable_x64(True):
        js = J.solve_ivp_scan(_jax_linear, jnp.asarray(Y0), jnp.asarray(TE),
                              args=jnp.asarray(A0), **kw)
        np.testing.assert_array_equal(steps, np.asarray(js.stats["n_steps"]))
    jg = _jax_scan_grads(_jax_linear, Y0, TE, A0, lambda ys: jnp.sum(jnp.sin(ys) * WEIGHTS),
                         rtol=1e-11, atol=1e-11, max_steps=512)
    for got, want in zip(tg, jg[:2]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


G = 9.81


def _ball_torch(t, y, args):
    return torch.stack((y[..., 1], torch.full_like(y[..., 1], -G)), dim=-1)


def _ball_jax(t, y, args):
    return jnp.stack((y[..., 1], jnp.full_like(y[..., 1], -G)), axis=-1)


def test_scan_driver_matches_while_driver_with_events():
    """``tests/test_events.py``'s scan-driver case: the scan driver's event
    times and status equal the loop driver's, and JAX's scan driver's in
    float64."""
    y0 = np.asarray([[10.0, 0.0], [5.0, 2.0]])
    ground = T.Event(lambda t, y, args: y[0], terminal=True, direction=-1.0)
    kw = dict(t_start=0.0, t_end=5.0, events=ground, rtol=1e-6, atol=1e-9, device="cpu")
    a = T.solve_ivp(_ball_torch, y0, None, **kw)
    s = T.solve_ivp_scan(_ball_torch, y0, None, max_steps=64, **kw)
    np.testing.assert_allclose(a.event_t.numpy(), s.event_t.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(a.status.numpy(), s.status.numpy())
    assert (s.status.numpy() == T.Status.EVENT.value).all()
    with jax.enable_x64(True):
        jground = J.Event(lambda t, y, args: y[0], terminal=True, direction=-1.0)
        js = J.solve_ivp_scan(_ball_jax, jnp.asarray(y0), None, max_steps=64, t_start=0.0,
                              t_end=5.0, events=jground, rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(s.event_t.numpy(), np.asarray(js.event_t), rtol=1e-9)
        np.testing.assert_array_equal(s.stats["n_steps"].numpy(), np.asarray(js.stats["n_steps"]))
