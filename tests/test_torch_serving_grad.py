"""Gradient serving in the port: training-time solves coalesce like forward
solves (mirrors ``tests/test_serving_grad.py``).

Held against the JAX package on the same numpy-seeded gradient streams in
float64: ``GradRequest``s through ``ScanAdjoint`` (the default gradient
driver) and through ``BacksolveAdjoint(mode="per_instance")``, per-request
parameter rows (``ODETerm(batched=False, batched_args=True)``); ``ys``,
``Grads.y0`` and ``Grads.args`` within 1e-9 (relative to each field's
largest entry), equal ``n_steps`` through ``ScanAdjoint``.  Within the port:
a served row against the same request solved alone through a gradient entry
of its batch class, bitwise; async against sync and two devices against
one, bitwise; the policies (forward and gradient requests never share a
bucket, the adjoint's static config splits buckets, default cotangent, a
service-wide ``default_grad_method``, prewarmed gradient entries) and the
submit-time validation errors.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.tools import serve_checks as sc  # noqa: E402

pytestmark = pytest.mark.reverse_diff

# The gradient driver of most tests here: ScanAdjoint runs exactly max_steps
# steps, and these solves need fewer than 32 (the default, 256, is held by
# test_single_request_matches_solo).
SCAN = T.ScanAdjoint("dopri5", max_steps=32)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def service(**kw):
    kw.setdefault("devices", ["cpu"])
    kw.setdefault("max_delay", None)
    kw.setdefault("default_grad_method", SCAN)
    return T.SolveService(**kw)


def grad_requests(n, seed, feats=(3,), dtype=np.float32, f=sc.decay, **extra):
    return sc.to_requests(sc.grad_stream(n, seed, feats, dtype), f, cls=T.GradRequest,
                          **extra)


def _rel_close(got, want, rtol=1e-9):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(want).max())))


def jax_serve_grads(dicts, f, method, **kw):
    """The gradient stream served by the JAX package's SolveService in
    float64; each result as ``(ys, n_steps or None, grads)`` in numpy."""
    def arr(v):
        return jax.tree_util.tree_map(jnp.asarray, v)

    with jax.enable_x64(True):
        svc = J.SolveService(max_delay=None, **kw)
        futs = [svc.submit(J.GradRequest(
            f=f, method=method, **{k: v if isinstance(v, float) else arr(v)
                                   for k, v in d.items()})) for d in dicts]
        svc.flush()
        out = []
        for fut in futs:
            view, grads = fut.result()
            steps = view.stats.get("n_steps")
            out.append((np.asarray(view.ys), None if steps is None else np.asarray(steps),
                        jax.tree_util.tree_map(np.asarray, grads)))
        return out


def port_serve(reqs, **kw):
    svc = service(**kw)
    futs = [svc.submit(r) for r in reqs]
    svc.flush()
    return svc, [fut.result() for fut in futs]


def assert_against_jax(got, want, steps=True):
    for (view, grads), (ys, jsteps, jgrads) in zip(got, want):
        _rel_close(view.ys.numpy(), ys)
        if steps:
            np.testing.assert_array_equal(view.stats["n_steps"].numpy(), jsteps)
        _rel_close(grads.y0.numpy(), jgrads.y0)
        if jgrads.args is None:
            assert grads.args is None
        elif isinstance(jgrads.args, dict):
            assert set(grads.args) == set(jgrads.args)
            for k in jgrads.args:
                _rel_close(grads.args[k].numpy(), jgrads.args[k])
        else:
            _rel_close(grads.args.numpy(), jgrads.args)


def single(t, y, a):
    return -a["rate"] * y + a["drive"] * torch.sin(t)


def single_jax(t, y, a):
    return -a["rate"] * y + a["drive"] * jnp.sin(t)


def row_dicts(n, seed):
    rng = np.random.default_rng(seed)
    return [dict(y0=rng.uniform(0.5, 1.5, (3,)), t0=0.0, t1=1.0,
                 args={"rate": rng.uniform(0.5, 2.0, (3,)),
                       "drive": np.asarray(rng.uniform(-1.0, 1.0))},
                 cotangent=rng.normal(size=(3,))) for _ in range(n)]


class TestAgainstJax:
    @pytest.mark.parametrize("driver", ["scan", "backsolve"])
    def test_grad_stream_float64(self, driver):
        dicts = sc.grad_stream(7, seed=1, feats=(3, 2), dtype=np.float64)
        if driver == "scan":
            jdrv = J.ScanAdjoint(J.Stepper("dopri5"), max_steps=64)
            drv = T.ScanAdjoint("dopri5", max_steps=64)
        else:
            kw = dict(mode="per_instance", rtol=1e-10, atol=1e-12)
            jdrv = J.BacksolveAdjoint(J.Stepper("dopri5"), **kw)
            drv = T.BacksolveAdjoint("dopri5", **kw)
        if driver == "backsolve":  # tolerances of the driver, not of each request
            dicts = [{k: v for k, v in d.items() if k != "rtol"} for d in dicts]
        want = jax_serve_grads(dicts, sc.decay, jdrv, max_batch=4)
        svc, got = port_serve(sc.to_requests(dicts, sc.decay, cls=T.GradRequest,
                                             method=drv), max_batch=4)
        assert_against_jax(got, want, steps=driver == "scan")
        st = svc.stats()
        assert st["n_grad_solves"] == 7 and st["n_buckets"] == 2

    def test_per_request_parameter_rows_float64(self):
        dicts = row_dicts(3, seed=8)
        want = jax_serve_grads(
            dicts, J.ODETerm(single_jax, batched=False, batched_args=True),
            J.ScanAdjoint(J.Stepper("dopri5"), max_steps=64), max_batch=4)
        svc, got = port_serve(sc.to_requests(
            dicts, T.ODETerm(single, batched=False, batched_args=True), cls=T.GradRequest,
            method=T.ScanAdjoint("dopri5", max_steps=64)), max_batch=4)
        assert svc.stats()["n_buckets"] == 1
        assert_against_jax(got, want)


def solve_grad_direct(req, batch_class, method=None):
    """This request alone through a gradient entry of the given batch class
    (its row replicated), as the service would submit it."""
    drv = method if method is not None else SCAN
    solver = T.CompiledSolver(drv, donate=False)
    f = req.f
    if isinstance(drv, T.BacksolveAdjoint) and req.args is not None \
            and not isinstance(f, T.ODETerm):
        f = T.ODETerm(f, batched=True, with_args=True, batched_args=True)

    def rep(x):
        return torch.stack([torch.as_tensor(np.asarray(x))] * batch_class)

    tree = lambda x: torch.utils._pytree.tree_map(rep, x)
    ct = req.cotangent if req.cotangent is not None else np.ones_like(req.y0)
    return solver.solve(f, tree(req.y0), None, t_start=rep(req.t0).float(),
                        t_end=rep(req.t1).float(),
                        args=None if req.args is None else tree(req.args),
                        rtol=rep(req.rtol if req.rtol is not None else drv.rtol).float(),
                        atol=rep(req.atol if req.atol is not None else drv.atol).float(),
                        cotangent=tree(ct), device="cpu")


def assert_grad_result(fut, req, batch_class, method=None):
    view, grads = fut.result()
    ref = solve_grad_direct(req, batch_class, method)
    assert torch.equal(view.ys[0], ref.ys[0])
    assert torch.equal(grads.y0, ref.grads.y0[0])
    if req.args is None:
        assert grads.args is None
    else:
        assert torch.equal(grads.args, ref.grads.args[0])


class TestServedGrads:
    def test_single_request_matches_solo(self):
        """The default gradient driver: a ScanAdjoint over the stepper."""
        svc = T.SolveService(max_batch=8, max_delay=None, devices=["cpu"],
                             default_method="dopri5")
        (req,) = grad_requests(1, seed=0)
        fut = svc.submit(req)
        assert fut._bucket.driver.static_key() == T.ScanAdjoint("dopri5").static_key()
        svc.flush()
        assert_grad_result(fut, req, 1, method=T.ScanAdjoint(T.Stepper("dopri5")))
        st = svc.stats()
        assert st["n_grad_solves"] == 1 and st["grad_device_s"] > 0.0

    def test_coalesced_bucket_matches_same_class_solo(self):
        svc = service(max_batch=8, default_method="dopri5")
        reqs = grad_requests(5, seed=1)
        futures = [svc.submit(r) for r in reqs]
        svc.flush()
        assert svc.stats()["n_pad_rows"] == 3
        for req, fut in zip(reqs, futures):
            assert_grad_result(fut, req, 8)
        assert svc.stats()["n_grad_solves"] == 5

    def test_forward_and_grad_requests_never_share_a_bucket(self):
        svc = service(max_batch=4, default_method="dopri5")
        greqs = grad_requests(3, seed=2)
        freqs = [T.SolveRequest(f=sc.decay, y0=g.y0, t0=g.t0, t1=g.t1, args=g.args,
                                rtol=g.rtol) for g in greqs]
        gfuts = [svc.submit(r) for r in greqs]
        ffuts = [svc.submit(r) for r in freqs]
        assert svc.stats()["n_buckets"] == 2
        svc.flush()
        for req, gfut, ffut in zip(greqs, gfuts, ffuts):
            assert_grad_result(gfut, req, 4)
            sol = ffut.result()
            assert sol.grads is None
            assert torch.equal(sol.ys, gfut.result()[0].ys)
        st = svc.stats()
        assert st["n_grad_solves"] == 3 and st["n_completed"] == 6

    def test_default_cotangent_sums_state_gradient(self):
        svc = service(max_batch=4, default_method="dopri5")
        (req,) = grad_requests(1, seed=3)
        req = T.GradRequest(f=req.f, y0=req.y0, t0=req.t0, t1=req.t1, args=req.args,
                            rtol=req.rtol)
        fut = svc.submit(req)
        svc.flush()
        assert_grad_result(fut, req, 1)

    def test_grad_flag_implied_by_cotangent(self):
        (g,) = grad_requests(1, seed=4)
        req = T.SolveRequest(f=sc.decay, y0=g.y0, t0=g.t0, t1=g.t1, args=g.args,
                             rtol=g.rtol, cotangent=g.cotangent)
        assert not req.grad
        svc = service(max_batch=4, default_method="dopri5")
        fut = svc.submit(req)
        svc.flush()
        _, grads = fut.result()
        assert grads.y0.shape == g.y0.shape
        assert svc.stats()["n_grad_solves"] == 1

    def test_no_args_request_has_no_args_gradient(self):
        def free_decay(t, y, args):
            return -y

        svc = service(max_batch=4, default_method="dopri5")
        req = T.GradRequest(f=free_decay, y0=np.ones(3, np.float32), t0=0.0, t1=1.0)
        fut = svc.submit(req)
        svc.flush()
        assert fut.result()[1].args is None
        assert_grad_result(fut, req, 1)
        np.testing.assert_allclose(fut.result()[1].y0.numpy(), np.exp(-1.0), rtol=1e-3)


class TestAdjointConfigurationBuckets:
    def test_backsolve_adjoint_served_matches_solo(self):
        drv = T.BacksolveAdjoint(T.Stepper("dopri5"), mode="per_instance", rtol=1e-6,
                                 atol=1e-8)
        svc = service(max_batch=4)
        reqs = grad_requests(3, seed=5, method=drv)
        futures = [svc.submit(r) for r in reqs]
        svc.flush()
        for req, fut in zip(reqs, futures):
            assert_grad_result(fut, req, 4, method=drv)
        assert svc.stats()["n_grad_solves"] == 3

    def test_adjoint_identity_splits_buckets(self):
        svc = service(max_batch=8)
        methods = [
            SCAN,
            T.ScanAdjoint(T.Stepper("dopri5"), max_steps=32, checkpoint_every=16),
            T.BacksolveAdjoint(T.Stepper("dopri5"), mode="per_instance"),
            T.BacksolveAdjoint(T.Stepper("dopri5"), mode="per_instance", max_steps=5_000),
        ]
        futures = []
        for i, m in enumerate(methods):
            (req,) = grad_requests(1, seed=6 + i, method=m)
            futures.append((svc.submit(req), req, m))
        assert svc.stats()["n_buckets"] == len(methods)
        svc.flush()
        for fut, req, m in futures:
            assert_grad_result(fut, req, 1, method=m)

    def test_default_grad_method_is_service_wide(self):
        drv = T.BacksolveAdjoint(T.Stepper("dopri5"), mode="per_instance", rtol=1e-6,
                                 atol=1e-8)
        svc = service(max_batch=4, default_grad_method=drv, default_method="dopri5")
        (req,) = grad_requests(1, seed=7)
        fwd = T.SolveRequest(f=sc.decay, y0=req.y0, t0=req.t0, t1=req.t1, args=req.args)
        gfut, ffut = svc.submit(req), svc.submit(fwd)
        svc.flush()
        assert_grad_result(gfut, req, 1, method=drv)
        assert ffut.result().grads is None

    def test_backsolve_per_instance_parameter_rows(self):
        """Each instance's own row-sized parameter adjoint: the served row
        gradients against the closed form y1 = y0 exp(-r)."""
        def one(t, y, rate):
            return -rate * y

        drv = T.BacksolveAdjoint(T.Stepper("dopri5"), mode="per_instance", rtol=1e-8,
                                 atol=1e-10)
        rng = np.random.default_rng(9)
        svc = service(max_batch=4)
        reqs = [T.GradRequest(f=T.ODETerm(one, batched=False, batched_args=True),
                              y0=rng.uniform(0.5, 1.5, (3,)).astype(np.float32), t0=0.0,
                              t1=1.0, method=drv, rtol=1e-6, atol=1e-8,
                              args=rng.uniform(0.5, 2.0, (3,)).astype(np.float32))
                for _ in range(3)]
        futures = [svc.submit(r) for r in reqs]
        svc.flush()
        for req, fut in zip(reqs, futures):
            _, grads = fut.result()
            np.testing.assert_allclose(grads.args.numpy(), -req.y0 * np.exp(-req.args),
                                       rtol=1e-3)
            np.testing.assert_allclose(grads.y0.numpy(), np.exp(-req.args), rtol=1e-3)


def _assert_same(got, ref):
    for g, r in zip(got, ref):
        if isinstance(g, tuple):
            (gv, gg), (rv, rg) = g, r
            assert torch.equal(gv.ys, rv.ys)
            for a, b in zip(torch.utils._pytree.tree_leaves(gg),
                            torch.utils._pytree.tree_leaves(rg)):
                assert torch.equal(a, b)
        else:
            assert torch.equal(g.ys, r.ys)


class TestAsyncAndMultiDevice:
    def test_out_of_order_harvest_bitwise(self):
        def run(max_inflight):
            rng = np.random.default_rng(10)
            ops = np.random.default_rng(11)
            svc = service(max_batch=4, max_inflight=max_inflight, default_method="dopri5")
            futures = []
            for i in range(16):
                feat = (2, 3, 5)[i % 3]
                if i % 2:
                    (req,) = grad_requests(1, seed=int(rng.integers(1 << 30)), feats=(feat,))
                else:
                    req = T.SolveRequest(
                        f=sc.decay, y0=rng.uniform(0.5, 1.5, (feat,)).astype(np.float32),
                        t0=0.0, t1=1.0, args=rng.uniform(0.5, 2.0, (feat,)).astype(np.float32))
                futures.append(svc.submit(req))
                op = ops.integers(0, 4)
                if op == 0:
                    svc.poll()
                elif op == 1:
                    svc.drain(1)
                elif op == 2:
                    futures[int(ops.integers(0, len(futures)))].result()
            svc.flush()
            return [f.result() for f in futures]

        _assert_same(run(max_inflight=2), run(max_inflight=0))

    def test_two_devices_round_robin_bitwise(self):
        def run(devices, max_inflight):
            svc = service(max_batch=2, max_inflight=max_inflight, devices=devices,
                          default_method="dopri5")
            futures = [svc.submit(r) for r in grad_requests(8, seed=12)]
            svc.flush()
            return svc, [f.result() for f in futures]

        _, ref = run(["cpu"], 0)
        svc, got = run(["cpu", "cpu"], 3)
        _assert_same(got, ref)
        st = svc.stats()
        assert st["n_grad_solves"] == 8 and st["n_devices"] == 2

    def test_prewarm_builds_grad_entries(self):
        svc = service(max_batch=4, default_method="dopri5")
        (example,) = grad_requests(1, seed=13)
        assert svc.prewarm(example) == 3  # classes 1, 2, 4
        assert svc.prewarm(example) == 0
        base = svc.stats()["cache_misses"]
        for n in (1, 2, 3):
            futures = [svc.submit(r) for r in grad_requests(n, seed=14 + n)]
            svc.flush()
            [f.result() for f in futures]
        st = svc.stats()
        assert st["cache_misses"] == base, "prewarmed gradient traffic must never build"
        assert st["cache_hits"] == 3


class TestGradValidation:
    def test_dense_grad_request_rejected(self):
        svc = service(max_batch=4, default_method="dopri5")
        with pytest.raises(ValueError, match="final state"):
            svc.submit(T.GradRequest(f=sc.decay, y0=np.ones(3, np.float32), t0=0.0, t1=1.0,
                                     t_eval=np.linspace(0.1, 0.9, 4, dtype=np.float32)))

    def test_non_differentiable_driver_rejected(self):
        svc = service(max_batch=4, default_method="dopri5")
        with pytest.raises(TypeError, match="reverse-differentiable"):
            svc.submit(T.GradRequest(f=sc.decay, y0=np.ones(3, np.float32), t0=0.0, t1=1.0,
                                     method=T.AutoDiffAdjoint(T.Stepper("dopri5"))))

    def test_joint_mode_backsolve_rejected(self):
        svc = service(max_batch=4, default_method="dopri5")
        with pytest.raises(TypeError, match="per_instance"):
            svc.submit(T.GradRequest(f=sc.decay, y0=np.ones(3, np.float32), t0=0.0, t1=1.0,
                                     method=T.BacksolveAdjoint(T.Stepper("dopri5"),
                                                               mode="joint")))

    def test_mis_shaped_cotangent_rejected(self):
        svc = service(max_batch=4, default_method="dopri5")
        with pytest.raises(ValueError, match="cotangent leaf shape"):
            svc.submit(T.GradRequest(f=sc.decay, y0=np.ones(3, np.float32), t0=0.0, t1=1.0,
                                     cotangent=np.ones(4, np.float32)))

    def test_mis_structured_cotangent_rejected(self):
        def f(t, y, args):
            return {"a": -y["a"]}

        svc = service(max_batch=4, default_method="dopri5")
        with pytest.raises(ValueError, match="structure"):
            svc.submit(T.GradRequest(f=f, y0={"a": np.ones(2, np.float32)}, t0=0.0, t1=1.0,
                                     cotangent=np.ones(2, np.float32)))
