"""The port's asynchronous serving engine: overlap must be invisible.

Mirrors ``tests/test_serving_async.py``: batches that start without waiting,
advance block by block and are harvested in any order, the bounded
in-flight window and round-robin placement are scheduling only, so every
request resolves with exactly the solution the blocking service
(``max_inflight=0``) gives the identical stream -- bitwise, since both build
identical batches.  On the CPU a captured entry runs its blocks without a
graph, one block per advance.  Devices are ``["cpu"]`` or ``["cpu", "cpu"]``
(one device named twice, as ``sharded_solve`` allows).

Also: an entry with a batch in flight is neither evicted (``cache_size=1``,
two keys in flight) nor loaded by a second batch (two batches of one key in
flight take an entry each), and the full-width stream of
``tools/serve_checks.py`` at a small width, async against sync.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as T  # noqa: E402
from repro_torch.tools import serve_checks as sc  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def make_stream(n, seed, feats=(2, 3, 5), dense_every=None):
    return sc.to_requests(sc.make_stream(n, seed, feats, dense_every), sc.decay)


def service(**kw):
    kw.setdefault("devices", ["cpu"])
    return T.SolveService(max_delay=None, default_method="dopri5", **kw)


def serve_stream(reqs, **kw):
    svc = service(**kw)
    futures = [svc.submit(r) for r in reqs]
    svc.flush()
    return svc, [f.result() for f in futures]


def assert_solutions_bitwise(got, ref, stats=None):
    """Bitwise equality of two served streams.  ``stats=None`` compares every
    accumulator (identical batch composition); otherwise only the named
    ones (``n_f_evals`` counts a batch's overhang)."""
    for g, r in zip(got, ref):
        assert torch.equal(g.ts, r.ts)
        for a, b in zip(torch.utils._pytree.tree_leaves(g.ys),
                        torch.utils._pytree.tree_leaves(r.ys)):
            assert torch.equal(a, b)
        assert torch.equal(g.status, r.status)
        for name in (g.stats if stats is None else stats):
            assert torch.equal(g.stats[name], r.stats[name]), name


def hold_harvest(svc):
    """Turn off the non-blocking harvest so that batches stay in flight;
    blocking harvests (drain, result, backpressure) still run."""
    svc._harvest_ready = lambda: 0


def release_harvest(svc):
    del svc.__dict__["_harvest_ready"]


class TestAsyncEqualsSync:
    def test_final_state_stream_bitwise(self):
        _, ref = serve_stream(make_stream(24, seed=0), max_batch=8, max_inflight=0)
        svc, got = serve_stream(make_stream(24, seed=0), max_batch=8, max_inflight=4)
        assert_solutions_bitwise(got, ref)
        assert svc.stats()["n_completed"] == 24

    def test_dense_stream_bitwise(self):
        _, ref = serve_stream(make_stream(18, seed=1, dense_every=1), max_batch=4,
                              max_inflight=0)
        _, got = serve_stream(make_stream(18, seed=1, dense_every=1), max_batch=4,
                              max_inflight=4)
        assert_solutions_bitwise(got, ref)

    def test_interleaved_submit_poll_result_bitwise(self):
        _, ref = serve_stream(make_stream(20, seed=2), max_batch=4, max_inflight=0)
        rng = np.random.default_rng(7)
        svc = service(max_batch=4, max_inflight=2)
        futures = []
        for r in make_stream(20, seed=2):
            futures.append(svc.submit(r))
            op = rng.integers(0, 4)
            if op == 0:
                svc.poll()
            elif op == 1:
                svc.drain(1)
            elif op == 2:
                fut = futures[int(rng.integers(0, len(futures)))]
                assert bool(fut.result().success.all())
        svc.flush()
        got = [f.result() for f in futures]
        assert_solutions_bitwise(got, ref, stats=("n_steps", "n_accepted"))
        st = svc.stats()
        assert st["n_inflight"] == 0 and st["queue_depth"] == 0
        assert st["n_completed"] == 20

    def test_hypothesis_interleaving_property(self):
        pytest.importorskip("hypothesis")
        from hypothesis import given, settings, strategies as st

        @settings(max_examples=15, deadline=None)
        @given(seed=st.integers(0, 2**30),
               n=st.integers(1, 12),
               max_inflight=st.sampled_from([1, 2, 4]),
               ops=st.lists(st.integers(0, 3), min_size=0, max_size=12))
        def run(seed, n, max_inflight, ops):
            _, ref = serve_stream(make_stream(n, seed=seed, dense_every=3), max_batch=4,
                                  max_inflight=0)
            svc = service(max_batch=4, max_inflight=max_inflight)
            futures = [svc.submit(r) for r in make_stream(n, seed=seed, dense_every=3)]
            for i, op in enumerate(ops):
                if op == 0:
                    svc.poll()
                elif op == 1:
                    svc.drain(1)
                elif op == 2:
                    svc.flush()
                else:
                    futures[i % n].result()
            svc.flush()
            got = [f.result() for f in futures]
            assert_solutions_bitwise(got, ref, stats=("n_steps", "n_accepted"))

        run()

    def test_batches_advance_a_block_at_a_time(self):
        """A captured batch in flight advances one block of k steps per
        non-blocking probe: poll resolves it only after as many polls as
        it has blocks."""
        svc = service(max_batch=2, max_inflight=4)
        dicts = [dict(d, rtol=1e-10, atol=1e-12) for d in sc.make_stream(2, 3, feats=(3,))]
        futures = [svc.submit(r) for r in sc.to_requests(dicts, sc.decay)]
        (rec,) = svc._inflight
        polls = 0
        while not all(f._solution is not None for f in futures):
            svc.poll()
            polls += 1
        runner = rec.run.runner
        iters = max(int(f.result().stats["n_steps"].max()) for f in futures)
        assert polls - 1 == runner.replays == runner.reads == -(-iters // runner.k) > 1


class TestInflightWindow:
    def test_backpressure_bounds_the_window(self):
        svc = service(max_batch=2, max_inflight=2)
        hold_harvest(svc)
        for r in make_stream(16, seed=3, feats=(2, 3, 5, 7)):
            svc.submit(r)
        svc.flush()
        st = svc.stats()
        assert st["n_batches"] == 8 and st["peak_inflight"] <= 2
        assert st["n_backpressure_waits"] == 6, \
            "every launch past the window must block on the oldest one"
        release_harvest(svc)
        svc.drain()
        assert svc.stats()["n_inflight"] == 0

    def test_max_inflight_zero_is_synchronous(self):
        svc = service(max_batch=2, max_inflight=0)
        futures = [svc.submit(r) for r in make_stream(4, seed=4, feats=(3,))]
        assert all(f._solution is not None for f in futures)
        st = svc.stats()
        assert st["n_inflight"] == 0 and st["peak_inflight"] == 1
        assert st["n_backpressure_waits"] == 0

    def test_drain_is_bounded_and_ordered(self):
        svc = service(max_batch=2, max_inflight=8)
        hold_harvest(svc)
        futures = [svc.submit(r) for r in make_stream(8, seed=5, feats=(2, 3, 5, 7))]
        svc.flush()
        assert svc.stats()["n_inflight"] == 4
        assert svc.drain(1) == 1
        assert futures[0]._solution is not None
        assert svc.stats()["n_inflight"] == 3
        assert svc.drain() == 3
        release_harvest(svc)
        assert all(f.done() for f in futures)


    def test_blocking_harvest_keeps_other_batches_moving(self):
        """While the host blocks on one batch, it advances the others in
        flight (a device runs every launch queued on it): the second batch
        has run blocks by the time the first one is delivered."""
        svc = service(max_batch=2, max_inflight=4)
        hold_harvest(svc)
        dicts = [dict(d, rtol=1e-10, atol=1e-12)
                 for d in sc.make_stream(4, 3, feats=(2, 3))]
        futures = [svc.submit(r) for r in sc.to_requests(dicts, sc.decay)]
        first, second = svc._inflight
        assert first.run.it == second.run.it == 0
        futures[0].result()
        assert second.run.it > 0 and second.run.runner.replays > 1
        release_harvest(svc)
        assert all(bool(f.result().success.all()) for f in futures)


class TestEntriesInFlight:
    def test_in_flight_entry_is_not_evicted(self):
        """cache_size=1 and two keys in flight on one slot: the second key's
        entry does not evict the first one's while its batch runs; the cache
        shrinks back once both are harvested."""
        _, ref = serve_stream(make_stream(4, seed=6, feats=(2, 3)), max_batch=2,
                              max_inflight=0, cache_size=1)
        svc = service(max_batch=2, max_inflight=4, cache_size=1)
        hold_harvest(svc)
        futures = [svc.submit(r) for r in make_stream(4, seed=6, feats=(2, 3))]
        (solver,) = svc._solvers[next(iter(svc._solvers))]
        entries = list(solver._cache.data.values())
        assert len(entries) == 2 and all(e.busy and e.runner is not None for e in entries)
        release_harvest(svc)
        got = [f.result() for f in futures]
        assert_solutions_bitwise(got, ref)
        assert not any(e.busy for e in entries)
        # The first key again: a hit, and the cache drops the idle other.
        again = [svc.submit(r) for r in make_stream(2, seed=7, feats=(2,))]
        assert bool(again[1].result().success.all())
        assert solver.cache_info().currsize == 1
        assert [e.runner is None for e in entries] == [False, True]

    def test_one_key_in_flight_twice_takes_two_entries(self):
        """Two batches of one key in flight: the second finds the first slot's
        entry busy and takes an entry of its own in a second slot; a busy
        entry refuses to start again."""
        _, ref = serve_stream(make_stream(4, seed=8, feats=(3,)), max_batch=2,
                              max_inflight=0)
        svc = service(max_batch=2, max_inflight=2)
        hold_harvest(svc)
        futures = [svc.submit(r) for r in make_stream(4, seed=8, feats=(3,))]
        slots = svc._solvers[next(iter(svc._solvers))]
        assert len(slots) == 2 and svc.stats()["n_inflight"] == 2
        (a,), (b,) = (list(s._cache.data.values()) for s in slots)
        assert a.key == b.key and a.busy and b.busy and a.runner is not b.runner
        with pytest.raises(RuntimeError, match="in flight"):
            a.runner.start(None, None, None, None, None, "vf")
        release_harvest(svc)
        assert_solutions_bitwise([f.result() for f in futures], ref)
        # Both idle now: the next batch of the key takes the first slot.
        for r in make_stream(2, seed=9, feats=(3,)):
            svc.submit(r)
        assert slots[0].cache_info().hits == 1 and slots[1].cache_info().hits == 0


class TestDevicePlacement:
    def test_round_robin_across_devices(self):
        devs = ["cpu", "cpu"]
        n_launch = 4
        svc = service(max_batch=2, max_inflight=n_launch + 2, devices=devs)
        hold_harvest(svc)
        for r in make_stream(2 * n_launch, seed=6, feats=tuple(range(2, 2 + n_launch))):
            svc.submit(r)
        placed = [rec.device for rec in svc._inflight]
        assert placed == [torch.device("cpu")] * n_launch
        assert svc._rr == n_launch
        release_harvest(svc)
        svc.drain()
        assert svc.stats()["n_devices"] == 2

    def test_two_devices_bitwise_equal_one(self):
        _, ref = serve_stream(make_stream(12, seed=8, dense_every=2), max_batch=4,
                              max_inflight=0, devices=["cpu"])
        svc, got = serve_stream(make_stream(12, seed=8, dense_every=2), max_batch=4,
                                max_inflight=4, devices=["cpu", "cpu"])
        assert_solutions_bitwise(got, ref)
        assert svc.stats()["n_batches"] >= 2

    def test_prewarm_covers_every_device(self):
        """One entry per class per distinct device: ``["cpu", "cpu"]`` names
        one device, so its second prewarm spec is the first one's entry."""
        svc = service(max_batch=2, devices=["cpu", "cpu"])
        example = make_stream(1, seed=9, feats=(3,))[0]
        assert svc.prewarm(example) == 2  # classes 1, 2
        assert svc.prewarm(example) == 0
        futures = [svc.submit(r) for r in make_stream(4, seed=9, feats=(3,))]
        svc.flush()
        [f.result() for f in futures]
        st = svc.stats()
        assert st["cache_misses"] == 2, "prewarmed traffic must never build"
        assert st["cache_hits"] >= 2


def test_full_width_stream_small_async_equals_sync():
    """tools/serve_checks' full-width stream at f = 6, hidden 16: one bucket
    key per eval class, rows coalesced to the batch ceiling, async (the
    window of 4) against the blocking service, bitwise."""
    shape = dict(b=1, f=6, n=64, hidden=16)

    def run(max_inflight):
        f, dicts = sc.full_width_stream("cpu", n=44, shape=shape)
        svc = service(max_batch=16, max_inflight=max_inflight)
        futures = [svc.submit(r) for r in sc.to_requests(dicts, f)]
        svc.flush()
        return svc, [fut.result() for fut in futures], dicts

    svc, got, dicts = run(4)
    _, ref, _ = run(0)
    assert_solutions_bitwise(got, ref)
    st = svc.stats()
    assert st["n_buckets"] == 2 and st["n_batches"] == 4 and st["n_pad_rows"] == 4
    for sol, d in zip(got, dicts):
        assert bool(sol.success.all())
        n = None if d["t_eval"] is None else len(d["t_eval"])
        assert sol.ys.shape == ((1, 6) if n is None else (1, n, 6))
