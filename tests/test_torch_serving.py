"""The port's request service (``repro_torch.core.serving``) on the CPU,
mirroring ``tests/test_serving.py``'s classes.

Covers: the same numpy-seeded streams served by the JAX package's
``SolveService`` and the port's, in float64 (final state, dense grids of
mixed lengths, structured states, per-request args): equal ``status``,
``n_steps`` and ``n_accepted``, ``ys`` within 1e-9 -- not bitwise across
frameworks (ROADMAP C-2: the reference's own bitwise serving tests fail on
this tree); within the port a served row against the same request solved
alone; the queueing policies with the injectable clock (size, deadline,
bounded queue, ``result(flush=False)``, a failed batch); ``prewarm`` counts
and a flush that hits the cache; validation errors with the reference's
exception types and reasons; ``stats()``'s keys against the reference's;
``next_pow2``; the ``Solution`` views (``slice_batch`` with events,
``truncate_eval``, ``to_host``) against the reference; ``serve_ode --device
cpu``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core.serving import next_pow2  # noqa: E402
from repro_torch.launch import serve_ode  # noqa: E402
from repro_torch.tools import serve_checks as sc  # noqa: E402

CPU = ["cpu"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def service(**kw):
    kw.setdefault("devices", CPU)
    kw.setdefault("max_delay", None)
    return T.SolveService(**kw)


def make_requests(n, rng, feat=3, n_eval=None, f=sc.decay, method=None):
    """n mixed-value float32 requests of one shape class (the reference's
    ``make_requests``, drawn in its order, as numpy arrays)."""
    reqs = []
    for _ in range(n):
        reqs.append(T.SolveRequest(
            f=f,
            y0=rng.uniform(0.5, 1.5, (feat,)).astype(np.float32),
            t0=float(rng.uniform(0.0, 0.2)),
            t1=float(rng.uniform(0.8, 1.2)),
            t_eval=(None if n_eval is None
                    else np.linspace(0.1, 0.7, n_eval, dtype=np.float32)),
            args=rng.uniform(0.5, 2.0, (feat,)).astype(np.float32),
            rtol=float(rng.choice([1e-3, 1e-4, 1e-5])),
            method=method,
        ))
    return reqs


def solve_direct(req, t_eval=None):
    """This request alone, b = 1, through the port's CompiledSolver."""
    solver = T.CompiledSolver(T.AutoDiffAdjoint(T.Stepper("dopri5")), donate=False)
    y0 = torch.as_tensor(req.y0)
    td = y0.dtype
    vec = lambda v: torch.tensor([v], dtype=td)
    return solver.solve(req.f, y0[None], None if t_eval is None else torch.as_tensor(
        t_eval, dtype=td)[None], t_start=vec(req.t0), t_end=vec(req.t1),
        args=torch.as_tensor(req.args)[None], rtol=vec(req.rtol if req.rtol else 1e-3),
        atol=vec(req.atol if req.atol else 1e-6), device="cpu")


def _jnp(x):
    return jax.tree_util.tree_map(jnp.asarray, x)


def jax_serve(dicts, f, **kw):
    """The stream served by the JAX package's SolveService in float64;
    every result as numpy arrays."""
    with jax.enable_x64(True):
        svc = J.SolveService(max_delay=None, default_method="dopri5", **kw)
        futs = [svc.submit(J.SolveRequest(
            f=f, **{k: (v if k == "t_eval" or v is None or isinstance(v, float) else _jnp(v))
                    for k, v in d.items()})) for d in dicts]
        svc.flush()
        out = [jax.tree_util.tree_map(np.asarray, fut.result()) for fut in futs]
        return out, svc.stats()


def port_serve(dicts, f, **kw):
    svc = service(default_method="dopri5", **kw)
    futs = [svc.submit(r) for r in sc.to_requests(dicts, f)]
    svc.flush()
    return [fut.result() for fut in futs], svc


def assert_against_jax(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.status.numpy(), w.status)
        for k in ("n_steps", "n_accepted"):
            np.testing.assert_array_equal(g.stats[k].numpy(), w.stats[k], err_msg=k)
        np.testing.assert_allclose(g.ts.numpy(), w.ts, rtol=0, atol=1e-12)
        g_leaves = torch.utils._pytree.tree_leaves(g.ys)
        w_leaves = jax.tree_util.tree_leaves(w.ys)
        assert len(g_leaves) == len(w_leaves)
        for a, b in zip(g_leaves, w_leaves):
            assert a.dtype == torch.float64 and tuple(a.shape) == b.shape
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-9, atol=1e-9)


def pytree_decay(t, y, args):
    return {"a": -y["a"], "b": 2.0 * y["b"]}


def pytree_rates(t, y, args):
    return {"a": -args["k"] * y["a"], "b": args["w"] * y["b"]}


def pytree_dicts(n, seed, with_args):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        d = dict(y0={"a": rng.uniform(1, 2, (2,)), "b": np.asarray(rng.uniform(1, 2))},
                 t0=0.0, t1=1.0)
        if with_args:
            d["args"] = {"k": np.asarray(rng.uniform(0.5, 2.0)),
                         "w": np.asarray(rng.uniform(-1.0, 1.0))}
        out.append(d)
    return out


STREAMS = {
    "final-state": (lambda: sc.make_stream(10, seed=0, dtype=np.float64), sc.decay),
    "dense-mixed-lengths": (lambda: sc.make_stream(10, seed=1, dense_every=1,
                                                   dtype=np.float64), sc.decay),
    "dense-every-third": (lambda: sc.make_stream(12, seed=2, dense_every=3,
                                                 dtype=np.float64), sc.decay),
    "pytree-state": (lambda: pytree_dicts(3, 2, with_args=False), pytree_decay),
    "pytree-per-request-args": (lambda: pytree_dicts(3, 14, with_args=True), pytree_rates),
}


class TestAgainstJax:
    @pytest.mark.parametrize("stream", sorted(STREAMS))
    def test_same_stream_float64(self, stream):
        make, f = STREAMS[stream]
        want, jstats = jax_serve(make(), f, max_batch=4)
        got, svc = port_serve(make(), f, max_batch=4)
        assert_against_jax(got, want)
        st = svc.stats()
        for k in ("n_buckets", "n_batches", "n_rows", "n_pad_rows", "n_completed",
                  "solver/n_steps", "solver/n_accepted"):
            assert st[k] == jstats[k], k

    def test_per_request_args_share_one_bucket(self):
        svc = service(max_batch=4, default_method="dopri5")
        for r in sc.to_requests(pytree_dicts(3, 14, with_args=True), pytree_rates):
            svc.submit(r)
        assert svc.stats()["n_buckets"] == 1, \
            "requests with different args values must share a bucket"


class TestAgainstDirectSolves:
    def test_padded_bucket_matches_solo_solve(self):
        """5 mixed requests pad to a bucket of 8; every row is the solo
        CompiledSolver solve of its request (all but the whole-batch
        overhang count n_f_evals)."""
        rng = np.random.default_rng(0)
        svc = service(max_batch=8, default_method="dopri5")
        reqs = make_requests(5, rng)
        futures = [svc.submit(r) for r in reqs]
        svc.flush()
        assert svc.stats()["n_pad_rows"] == 3
        for req, fut in zip(reqs, futures):
            got, ref = fut.result(), solve_direct(req)
            assert torch.equal(got.ys, ref.ys) and torch.equal(got.ts, ref.ts)
            assert torch.equal(got.status, ref.status)
            for name in ("n_steps", "n_accepted"):
                assert torch.equal(got.stats[name], ref.stats[name]), name

    def test_dense_bucket_matches_solo_padded_grid(self):
        rng = np.random.default_rng(1)
        svc = service(max_batch=8, default_method="dopri5")
        reqs = [make_requests(1, rng, n_eval=n)[0] for n in (3, 5, 6, 8)]
        futures = [svc.submit(r) for r in reqs]
        svc.flush()
        for req, fut in zip(reqs, futures):
            got = fut.result()
            n = req.t_eval.shape[0]
            assert got.ts.shape == (1, n) and got.ys.shape == (1, n, 3)
            np.testing.assert_array_equal(got.ts.numpy()[0], req.t_eval)
            padded = np.concatenate([req.t_eval, np.full(next_pow2(n) - n, req.t_eval[-1],
                                                         np.float32)])
            ref = solve_direct(req, t_eval=padded)
            np.testing.assert_allclose(got.ys.numpy(), ref.ys.numpy()[:, :n], rtol=1e-6,
                                       atol=1e-7)
            assert torch.equal(got.stats["n_steps"], ref.stats["n_steps"])


class TestQueueingPolicies:
    def test_poll_harvests_with_deadlines_disabled(self):
        rng = np.random.default_rng(13)
        svc = service(max_batch=4, clock=lambda: 0.0)
        futures = [svc.submit(r) for r in make_requests(2, rng, method="dopri5")]
        assert svc.flush() == 1
        for _ in range(1000):  # poll alone resolves the futures, a block a poll
            svc.poll()
            if all(f._solution is not None for f in futures):
                break
        assert all(f._solution is not None for f in futures), \
            "poll() must advance and harvest in-flight batches with max_delay=None"
        assert svc.stats()["n_inflight"] == 0
        assert all(bool(f.result().success.all()) for f in futures)

    def test_flush_on_size(self):
        rng = np.random.default_rng(3)
        svc = service(max_batch=4)
        futures = [svc.submit(r) for r in make_requests(4, rng, method="dopri5")]
        svc.drain()
        assert all(f.done() for f in futures)
        st = svc.stats()
        assert (st["queue_depth"], st["n_size_flushes"], st["n_batches"],
                st["n_pad_rows"]) == (0, 1, 1, 0)

    def test_out_of_order_completion_across_buckets(self):
        rng = np.random.default_rng(4)
        svc = service(max_batch=2)
        slow = svc.submit(make_requests(1, rng, feat=5, method="dopri5")[0])
        fast = [svc.submit(r) for r in make_requests(2, rng, feat=2, method="dopri5")]
        svc.drain()
        assert all(f.done() for f in fast), "full bucket must flush eagerly"
        assert not slow.done(), "half-full bucket must keep waiting"
        svc.flush()
        svc.drain()
        assert slow.done() and bool(slow.result().success.all())

    def test_flush_on_deadline(self):
        now = [0.0]
        rng = np.random.default_rng(5)
        svc = service(max_batch=8, max_delay=1.0, clock=lambda: now[0])
        fut = svc.submit(make_requests(1, rng, method="dopri5")[0])
        assert svc.poll() == 0 and not fut.done()
        now[0] = 0.99
        assert svc.poll() == 0 and not fut.done()
        now[0] = 1.0
        assert svc.poll() == 1
        svc.drain()
        assert fut.done()
        assert svc.stats()["n_deadline_flushes"] == 1
        f2 = svc.submit(make_requests(1, rng, method="dopri5")[0])
        now[0] = 2.5
        f3 = svc.submit(make_requests(1, rng, feat=7, method="dopri5")[0])
        svc.drain()
        assert f2.done(), "submit must deadline-flush other buckets"
        assert not f3.done()

    def test_bounded_queue_drains(self):
        rng = np.random.default_rng(6)
        svc = service(max_batch=8, max_queue=8)
        futures = [svc.submit(r) for r in make_requests(7, rng, method="dopri5")]
        f8 = svc.submit(make_requests(1, rng, feat=2, method="dopri5")[0])
        assert not f8.done() and svc.stats()["queue_depth"] == 8
        f9 = svc.submit(make_requests(1, rng, feat=4, method="dopri5")[0])
        svc.drain()
        assert all(f.done() for f in futures) and f8.done()
        assert not f9.done() and svc.stats()["queue_depth"] == 1

    def test_deadline_sweep_only_scans_waiting_buckets(self):
        rng = np.random.default_rng(12)
        svc = service(max_batch=2, max_delay=1.0, clock=lambda: 0.0)
        for feat in range(2, 8):
            [svc.submit(r) for r in make_requests(2, rng, feat=feat, method="dopri5")]
        assert svc.stats()["n_buckets"] == 6
        assert len(svc._waiting) == 0, "drained buckets must leave the sweep set"
        pending = svc.submit(make_requests(1, rng, feat=2, method="dopri5")[0])
        assert list(svc._waiting) == [pending._bucket.key]
        svc.flush()
        svc.drain()
        assert len(svc._waiting) == 0 and pending.done()

    def test_result_flush_semantics(self):
        rng = np.random.default_rng(7)
        svc = service(max_batch=8)
        fut = svc.submit(make_requests(1, rng, method="dopri5")[0])
        with pytest.raises(RuntimeError, match="still queued"):
            fut.result(flush=False)
        assert bool(fut.result().success.all())

    def test_failed_batch_delivers_error_and_service_survives(self):
        def bad(t, y, args):
            raise RuntimeError("boom")

        rng = np.random.default_rng(8)
        svc = service(max_batch=4)
        fut = svc.submit(T.SolveRequest(f=bad, y0=np.ones(3, np.float32), t0=0.0, t1=1.0))
        with pytest.raises(RuntimeError, match="boom"):
            fut.result()
        assert svc.stats()["n_failed_batches"] == 1
        ok = svc.submit(make_requests(1, rng, method="dopri5")[0])
        assert bool(ok.result().success.all())

    def test_failure_inside_the_loop_frees_the_entry(self):
        """A vector field that fails after the batch started (in a block at
        harvest) delivers its error; the entry is idle again afterwards."""
        calls = [0]

        def flaky(t, y, args):
            calls[0] += 1
            if calls[0] == 6:
                raise RuntimeError("late boom")
            return -y

        svc = service(max_batch=2, default_method="dopri5")
        reqs = [T.SolveRequest(f=flaky, y0=np.ones(3, np.float32), t0=0.0, t1=1.0)] * 2
        futs = [svc.submit(r) for r in reqs]
        with pytest.raises(RuntimeError, match="late boom"):
            futs[0].result()
        assert svc.stats()["n_failed_batches"] == 1 and svc.stats()["n_inflight"] == 0
        (solver,) = futs[0]._bucket.slots
        assert not any(e.busy for e in solver._cache.data.values())
        again = [svc.submit(r) for r in reqs]
        assert bool(again[1].result().success.all())


class TestPrewarm:
    def test_prewarm_builds_every_class_and_flushes_hit(self):
        rng = np.random.default_rng(9)
        svc = service(max_batch=8)
        example = make_requests(1, rng, method="dopri5")[0]
        assert svc.prewarm(example) == 4  # classes 1, 2, 4, 8
        assert svc.prewarm(example) == 0  # idempotent
        base = svc.stats()
        assert base["cache_misses"] == 4 and base["cache_hits"] == 0
        for n in (1, 2, 3, 8):  # classes 1, 2, 4 (padded), 8
            futures = [svc.submit(r) for r in make_requests(n, rng, method="dopri5")]
            svc.flush()
            assert all(bool(f.result().success.all()) for f in futures)
        st = svc.stats()
        assert st["cache_misses"] == 4, "prewarmed traffic must never build"
        assert st["cache_hits"] == 4 and st["n_programs"] == 4

    def test_numpy_and_torch_requests_of_one_dtype_share_a_bucket(self):
        """Dtypes are taken as given: a numpy and a torch request of one
        dtype share the bucket and the prewarmed entry; another dtype is
        another bucket."""
        svc = service(max_batch=4, default_method="dopri5")
        np_req = T.SolveRequest(f=sc.decay, y0=np.ones(3, np.float32), t0=0.0, t1=1.0,
                                args=np.full(3, 0.5, np.float32))
        assert svc.prewarm(np_req, batch_classes=[2]) == 1
        f1 = svc.submit(np_req)
        f2 = svc.submit(T.SolveRequest(f=sc.decay, y0=torch.ones(3), t0=0.0, t1=1.0,
                                       args=torch.full((3,), 0.5)))
        svc.flush()
        st = svc.stats()
        assert st["n_buckets"] == 1
        assert st["cache_misses"] == 1 and st["cache_hits"] == 1
        assert torch.equal(f1.result().ys, f2.result().ys)
        assert f1.result().ys.dtype == torch.float32
        svc.submit(T.SolveRequest(f=sc.decay, y0=np.ones(3), t0=0.0, t1=1.0,
                                  args=np.full(3, 0.5)))
        assert svc.stats()["n_buckets"] == 2

    def test_unwarmed_class_counts_a_miss(self):
        rng = np.random.default_rng(10)
        svc = service(max_batch=8)
        example = make_requests(1, rng, method="dopri5")[0]
        svc.prewarm(example, batch_classes=[4])
        [svc.submit(r) for r in make_requests(2, rng, method="dopri5")]
        svc.flush()
        assert svc.stats()["cache_misses"] == 2
        with pytest.raises(ValueError, match="batch class"):
            svc.prewarm(example, batch_classes=[3])


class TestValidationAndStats:
    def test_request_validation(self):
        svc = service(max_batch=4)
        with pytest.raises(ValueError, match="1-D"):
            svc.submit(T.SolveRequest(f=sc.decay, y0=np.ones((2, 2)), t0=0, t1=1))
        with pytest.raises(ValueError, match="rtol must be scalar"):
            svc.submit(T.SolveRequest(f=sc.decay, y0=np.ones(2), t0=0, t1=1,
                                      rtol=np.ones(2)))
        with pytest.raises(ValueError, match="1-D grid"):
            svc.submit(T.SolveRequest(f=sc.decay, y0=np.ones(2), t0=0, t1=1,
                                      t_eval=np.zeros((2, 2))))
        with pytest.raises(ValueError, match="no array leaves"):
            svc.submit(T.SolveRequest(f=sc.decay, y0={}, t0=0, t1=1))
        with pytest.raises(TypeError, match="final-state solves only"):
            svc.submit(T.SolveRequest(f=sc.decay, y0=np.ones(2), t0=0, t1=1,
                                      t_eval=np.linspace(0, 1, 3),
                                      method=T.BacksolveAdjoint("dopri5")))
        assert svc.stats()["n_requests"] == 0
        with pytest.raises(ValueError, match="power of two"):
            service(max_batch=6)
        with pytest.raises(ValueError, match="max_queue"):
            service(max_batch=8, max_queue=4)
        with pytest.raises(ValueError, match="max_inflight"):
            service(max_inflight=-1)
        with pytest.raises(ValueError, match="at least one device"):
            T.SolveService(devices=[])

    def test_default_devices_need_a_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.SolveService()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.SolveService(devices=["cuda"])

    def test_stats_keys_match_the_reference(self):
        dicts = sc.make_stream(6, seed=4, dense_every=2, dtype=np.float64)
        _, jstats = jax_serve(dicts, sc.decay, max_batch=4)
        _, svc = port_serve(dicts, sc.decay, max_batch=4)
        st = svc.stats()
        assert list(st) == list(jstats)
        assert st["pad_waste"] == pytest.approx(jstats["pad_waste"])

    def test_stats_surface_builds_on_registry(self):
        rng = np.random.default_rng(11)
        svc = service(max_batch=4)
        futures = [svc.submit(r) for r in make_requests(3, rng, method="dopri5")]
        svc.flush()
        svc.drain()
        st = svc.stats()
        assert st["pad_waste"] == pytest.approx(0.25)
        assert st["solves_per_sec"] > 0
        assert st["solver/n_steps"] == sum(float(f.result().stats["n_steps"].sum())
                                           for f in futures)
        assert st["solver/n_f_evals"] > 0

    def test_next_pow2(self):
        assert [next_pow2(n) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 16]
        with pytest.raises(ValueError):
            next_pow2(0)

    def test_exports_match_the_reference(self):
        for name in ("SolveService", "SolveRequest", "SolveFuture", "GradRequest"):
            assert name in T.__all__ and name in J.__all__


def fall(t, y, args):
    return torch.stack((y[..., 1], torch.full_like(y[..., 1], -9.81)), dim=-1)


def fall_jax(t, y, args):
    return jnp.stack((y[..., 1], jnp.full_like(y[..., 1], -9.81)), axis=-1)


class TestSolutionViews:
    def test_slice_batch_with_events_against_the_reference(self):
        y0 = np.asarray([[10.0, 0.0], [20.0, 0.0], [5.0, 1.0]])
        cond = lambda t, y, args: y[0]
        with jax.enable_x64(True):
            ev = J.Event(cond, terminal=True, direction=-1.0)
            jsol = J.solve_ivp(fall_jax, jnp.asarray(y0), None, t_start=0.0, t_end=10.0,
                               events=ev).slice_batch(slice(1, 3))
            jpart = jax.tree_util.tree_map(np.asarray, jsol)
        sol = T.solve_ivp(fall, y0, None, t_start=0.0, t_end=10.0, device="cpu",
                          events=T.Event(cond, terminal=True, direction=-1.0))
        part = sol.slice_batch(slice(1, 3))
        assert part.ys.shape == (2, 2) and part.event_t.shape == (2, 1)
        assert torch.equal(part.event_t, sol.event_t[1:3])
        assert torch.equal(part.stats["n_steps"], sol.stats["n_steps"][1:3])
        np.testing.assert_allclose(part.event_t.numpy(), jpart.event_t, rtol=1e-9)
        np.testing.assert_array_equal(part.event_mask.numpy(), jpart.event_mask)
        np.testing.assert_array_equal(part.stats["n_steps"].numpy(), jpart.stats["n_steps"])
        host = part.to_host()
        assert all(x.device.type == "cpu" for x in host._tensors())
        assert torch.equal(host.event_y, part.event_y)

    def test_truncate_eval_rejects_final_state(self):
        sol = T.solve_ivp(sc.decay, np.ones((2, 2)), None, t_start=0.0, t_end=1.0,
                          args=1.0, device="cpu")
        with pytest.raises(ValueError, match="dense-output"):
            sol.truncate_eval(1)
        with jax.enable_x64(True):
            jsol = J.solve_ivp(sc.decay, jnp.ones((2, 2)), None, t_start=0.0, t_end=1.0,
                               args=1.0)
            with pytest.raises(ValueError, match="dense-output"):
                jsol.truncate_eval(1)

    def test_views_against_the_reference(self):
        te = np.linspace(0, 1, 6)
        with jax.enable_x64(True):
            jview = J.solve_ivp(sc.decay, jnp.ones((3, 2)), jnp.asarray(te),
                                args=1.0).slice_batch(slice(0, 2)).truncate_eval(4).to_host()
        view = T.solve_ivp(sc.decay, np.ones((3, 2)), te, args=1.0,
                           device="cpu").slice_batch(slice(0, 2)).truncate_eval(4).to_host()
        assert isinstance(view, T.Solution) and dataclasses.is_dataclass(view)
        assert view.ys.shape == (2, 4, 2) == jview.ys.shape
        np.testing.assert_array_equal(view.ts.numpy(), jview.ts)
        np.testing.assert_allclose(view.ys.numpy(), jview.ys, rtol=1e-9)
        assert view.is_ready() and view.block_until_ready() is view


class TestServeOde:
    def test_cli_on_the_cpu(self, capsys):
        stats = serve_ode.main(["--device", "cpu", "--requests", "24", "--max-batch", "4",
                                "--prewarm", "--seed", "3"])
        assert stats["n_completed"] == 24 and stats["n_failed_batches"] == 0
        out = capsys.readouterr().out
        assert "24 fully successful" in out and "pad_waste" in out
        stats = serve_ode.main(["--device", "cpu", "--requests", "12", "--sync"])
        assert stats["n_completed"] == 12 and stats["peak_inflight"] == 1

    def test_cli_needs_a_card_by_default(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_ode.main(["--requests", "2"])
