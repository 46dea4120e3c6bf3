"""The port's request service on the card: batches replayed as captured CUDA
graphs, advanced block by block on streams of their own.

Held bitwise: the asynchronous service (a window of 4) builds the same
batches as the blocking one (``max_inflight=0``) and replays the same
graphs, so every request resolves with equal bits; a second pass of a
stream through the same service replays the entries the first captured (no
new capture, no kernel launched through a wrapper); an entry with a batch in
flight is not evicted (``cache_size=1``) and one key in flight twice takes
two entries, in two slots on two streams.  A batch's stream waits for the
work queued before it on the caller's stream: a prewarmed service handed
requests right after an in-place update of the weights, queued behind a
long kernel, serves what an unprewarmed service serves after a
synchronize.

These tests need a CUDA device and skip without one; they import no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_serving_card.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import SolveRequest, SolveService  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.tools import serve_checks as sc  # noqa: E402

SHAPE = dict(b=1, f=64, n=64, hidden=128)


@pytest.fixture
def cuda_device():
    """The card, or a skip: a CUDA graph has no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: served batches replay CUDA graphs")
    return torch.device("cuda")


def serve(svc, reqs):
    futures = [svc.submit(r) for r in reqs]
    svc.flush()
    return [f.result() for f in futures]


def bitwise(got, ref):
    for g, r in zip(got, ref):
        assert g.ys.device.type == "cpu"
        assert torch.equal(g.ys, r.ys) and torch.equal(g.ts, r.ts)
        assert torch.equal(g.status, r.status)
        for k in r.stats:
            assert torch.equal(g.stats[k], r.stats[k]), k


def entries(svc):
    return [e for slots in svc._solvers.values() for s in slots
            for e in s._cache.data.values()]


def test_async_equals_sync_and_second_pass_replays(cuda_device):
    f, dicts = sc.full_width_stream(cuda_device, n=96, shape=SHAPE)
    reqs = sc.to_requests(dicts, f)
    out = {}
    for window in (4, 0):
        svc = SolveService(max_batch=16, max_delay=None, max_inflight=window,
                           devices=[cuda_device])
        first = serve(svc, reqs)
        captures = sum(e.runner.captures for e in entries(svc))
        assert captures > 0 and all(e.runner is not None for e in entries(svc))
        for k in ops.launches:
            ops.launches[k] = 0
        second = serve(svc, reqs)
        bitwise(second, first)
        assert sum(e.runner.captures for e in entries(svc)) == captures, "recaptured"
        assert not any(ops.launches.values()), f"a replay launched {dict(ops.launches)}"
        st = svc.stats()
        assert st["n_failed_batches"] == 0 and st["n_completed"] == 2 * len(reqs)
        if window:
            assert st["peak_inflight"] > 1
        out[window] = second
    bitwise(out[4], out[0])
    assert all(bool(s.success.all()) for s in out[0])


def test_entries_in_flight(cuda_device):
    """Four batches in flight, two of each key, with cache_size=1: no entry
    is evicted, and each key's second batch takes a second slot, on a
    second stream."""
    f, dicts = sc.full_width_stream(cuda_device, n=16, shape=SHAPE)
    reqs = sc.to_requests(dicts, f)  # even: final state; odd: dense (two keys)
    ref = serve(SolveService(max_batch=4, max_delay=None, max_inflight=0,
                             devices=[cuda_device]), reqs)
    svc = SolveService(max_batch=4, max_delay=None, max_inflight=4, cache_size=1,
                       devices=[cuda_device])
    svc._harvest_ready = lambda: 0  # keep every batch in flight
    futures = [svc.submit(r) for r in reqs]
    (slots,) = svc._solvers.values()
    live = entries(svc)
    assert svc.stats()["n_inflight"] == 4 and len(slots) == 2 and len(live) == 4
    assert all(e.busy and e.runner.graphs for e in live)
    assert len({id(rec.stream) for rec in svc._inflight}) == 2
    del svc.__dict__["_harvest_ready"]
    bitwise([fut.result() for fut in futures], ref)
    assert not any(e.busy for e in live)


def test_batches_wait_for_the_callers_stream(cuda_device):
    rng = np.random.default_rng(3)
    w = torch.as_tensor(0.3 * rng.standard_normal((64, 64)), dtype=torch.float32,
                        device=cuda_device)
    w_new = 1.5 * w

    def field(t, y, args):
        return torch.tanh(y @ w)

    y0 = rng.standard_normal((8, 64)).astype(np.float32)
    reqs = [SolveRequest(f=field, y0=y0[i], t0=0.0, t1=2.0, rtol=1e-5, atol=1e-6)
            for i in range(8)]
    svc = SolveService(max_batch=8, max_delay=None, max_inflight=4, devices=[cuda_device])
    assert svc.prewarm(reqs[0], batch_classes=[8]) == 1
    torch.cuda._sleep(200_000_000)  # ~0.1 s of the caller's stream before the update
    w.copy_(w_new)
    got = serve(svc, reqs)
    torch.cuda.synchronize()
    ref = serve(SolveService(max_batch=8, max_delay=None, max_inflight=0,
                             devices=[cuda_device]), reqs)
    assert svc.stats()["cache_hits"] == 1
    bitwise(got, ref)
