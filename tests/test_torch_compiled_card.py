"""The compiled front end on the card: solves captured as CUDA graphs of k
steps (``core/graphs.py``) against the eager card solve.

Held bitwise: a captured solve replays the kernels the eager loop launches,
on the same inputs, so ``ys``, ``status`` and every statistic are equal (the
steps a block runs after every instance has stopped are masked no-ops).

These tests need a CUDA device and skip without one; they import no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_compiled_card.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    AutoDiffAdjoint,
    CompiledSolver,
    ScanAdjoint,
    Status,
    Stepper,
    sharded_solve,
)

MU = 2.0


@pytest.fixture
def cuda_device():
    """The card, or a skip: a CUDA graph has no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured loop runs CUDA graphs")
    return torch.device("cuda")


def vdp(t, y, mu):
    x, v = y[:, 0], y[:, 1]
    return torch.stack((v, mu * (1 - x**2) * v - x), dim=-1)


def mlp(t, y, p):
    return torch.tanh(y @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def _vdp_inputs(b=64, n=50, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    y0 = (np.array([2.0, 0.0]) + 0.1 * rng.standard_normal((b, 2))).astype(dtype)
    return y0, np.linspace(0.0, 6.0, n).astype(dtype)


def _mlp_inputs(device, b=128, f=64, h=128):
    rng = np.random.default_rng(1)
    args = {name: torch.as_tensor(w, dtype=torch.float32, device=device) for name, w in (
        ("w1", 2.0 * rng.standard_normal((f, h)) / np.sqrt(f)),
        ("b1", rng.standard_normal(h) / np.sqrt(f)),
        ("w2", 2.0 * rng.standard_normal((h, f)) / np.sqrt(h)),
        ("b2", rng.standard_normal(f) / np.sqrt(h)))}
    y0 = rng.standard_normal((b, f)).astype(np.float32)
    return y0, np.linspace(0.0, 4.0, 16, dtype=np.float32), args


def _bitwise(got, want, skip=()):
    assert torch.equal(got.ys, want.ys)
    assert torch.equal(got.status, want.status)
    assert torch.equal(got.ts, want.ts)
    for k in set(want.stats) - set(skip):
        assert torch.equal(got.stats[k], want.stats[k]), k


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("k", [1, 5, 16])
def test_replay_equals_eager_vdp(cuda_device, fused, k):
    y0, te = _vdp_inputs()
    drv = AutoDiffAdjoint(Stepper("dopri5"), rtol=1e-5, atol=1e-5, fused=fused)
    eager = drv.solve(vdp, y0, te, args=MU, device=cuda_device)
    solver = CompiledSolver(drv, k=k, donate=False)
    for _ in range(3):
        _bitwise(solver.solve(vdp, y0, te, args=MU, device=cuda_device), eager)
    handle = solver.compile(vdp, y0, te, args=MU, device=cuda_device)
    runner = handle.runner
    assert handle.captured and runner.captures == len(runner.graphs) == len(runner.sizes)
    nodes = runner.graph_nodes()
    assert sorted(nodes) == sorted(runner.sizes) and all(n > 0 for n in nodes.values())
    assert runner.pool_bytes() > 0 and runner.buffer_bytes > 0
    blocks = -(-int(eager.stats["n_steps"].max()) // k)
    assert runner.replays == runner.reads == 3 * blocks


@pytest.mark.parametrize("fused", [False, True])
def test_replay_equals_eager_mlp(cuda_device, fused):
    y0, te, args = _mlp_inputs(cuda_device)
    drv = AutoDiffAdjoint(Stepper("dopri5"), rtol=1e-5, atol=1e-5, fused=fused)
    eager = drv.solve(mlp, y0, te, args=args, device=cuda_device)
    solver = CompiledSolver(drv, donate=False)
    for _ in range(2):
        _bitwise(solver.solve(mlp, y0, te, args=args, device=cuda_device), eager)


def test_first_result_unchanged_by_second_call(cuda_device):
    y0, te = _vdp_inputs()
    solver = CompiledSolver(AutoDiffAdjoint(Stepper("dopri5"), rtol=1e-5), donate=False)
    first = solver.solve(vdp, y0, te, args=MU, device=cuda_device)
    kept = [first.ys.clone(), first.status.clone(), first.stats["n_steps"].clone()]
    y1, _ = _vdp_inputs(seed=4)
    second = solver.solve(vdp, y1, te, args=3.0, device=cuda_device)
    assert not torch.equal(second.ys, kept[0])
    assert torch.equal(first.ys, kept[0]) and torch.equal(first.status, kept[1])
    assert torch.equal(first.stats["n_steps"], kept[2])


def test_tolerance_change_does_not_recapture(cuda_device):
    y0, te = _vdp_inputs()
    drv = AutoDiffAdjoint(Stepper("dopri5"), rtol=1e-5, atol=1e-5)
    solver = CompiledSolver(drv, donate=False)
    solver.solve(vdp, y0, te, args=MU, device=cuda_device)
    runner = solver.compile(vdp, y0, te, args=MU, device=cuda_device).runner
    captures, misses = runner.captures, solver.cache_info().misses
    for rtol in (1e-6, 1e-4):
        got = solver.solve(vdp, y0, te, args=MU, rtol=rtol, device=cuda_device)
        want = AutoDiffAdjoint(Stepper("dopri5"), rtol=rtol, atol=1e-5).solve(
            vdp, y0, te, args=MU, device=cuda_device)
        _bitwise(got, want)
    assert runner.captures == captures and solver.cache_info().misses == misses


def test_no_sync_inside_a_block(cuda_device):
    """The buffer loads and every replay run under
    ``set_sync_debug_mode("error")``; only the flag read between blocks
    waits on the device.  A graph launch is not instrumented: that no step
    syncs is shown by the capture, which raises on a sync (see
    ``test_vector_field_that_syncs_makes_capture_raise``)."""
    y0, te, args = _mlp_inputs(cuda_device)
    drv = AutoDiffAdjoint(Stepper("dopri5"), rtol=1e-5, atol=1e-5)
    solver = CompiledSolver(drv, k=4, donate=False)
    want = solver.solve(mlp, y0, te, args=args, device=cuda_device)
    runner = solver.compile(mlp, y0, te, args=args, device=cuda_device).runner

    def guarded(fn):
        def call(*a, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return call

    runner.start, runner.replay = guarded(runner.start), guarded(runner.replay)
    replays = runner.replays
    _bitwise(solver.solve(mlp, y0, te, args=args, device=cuda_device), want)
    assert runner.replays > replays
    del runner.start, runner.replay


def test_cache_clear_frees_device_memory(cuda_device):
    """An entry holds its static buffers and graph pool while cached;
    dropping it frees them.  (vdp, elementwise, so that no library
    workspace stays allocated.)"""
    import gc

    y0, te = _vdp_inputs(b=4096)
    gc.collect()  # earlier tests' garbage must not be freed while this one measures
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda_device)
    solver = CompiledSolver(AutoDiffAdjoint(Stepper("dopri5"), rtol=1e-5), donate=False)
    solver.solve(vdp, y0, te, args=MU, device=cuda_device)
    runner = solver.compile(vdp, y0, te, args=MU, device=cuda_device).runner
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(cuda_device) - before
    assert held >= runner.buffer_bytes > 0
    solver.cache_clear()
    torch.cuda.synchronize()
    assert not runner.graphs and runner.state is None
    assert torch.cuda.memory_allocated(cuda_device) - before < held // 10


def test_capture_survives_the_cyclic_collector(cuda_device):
    """A capture keeps the cyclic collector out.  Here the vector field,
    while it is captured, leaves another entry's graphs in cyclic garbage,
    and the collector would run at the next allocation: destroying a graph
    then would invalidate the capture."""
    import gc

    y0, te = _vdp_inputs()
    drv = AutoDiffAdjoint(Stepper("dopri5"), rtol=1e-5, atol=1e-5)
    box = [CompiledSolver(drv, k=4, donate=False)]
    box[0].solve(vdp, y0, te, args=MU, device=cuda_device)

    def dropping_vf(t, y, mu):
        if box and torch.cuda.is_current_stream_capturing():
            cycle = [box.pop()]
            cycle.append(cycle)
        return vdp(t, y, mu)

    eager = drv.solve(vdp, y0, te, args=MU, device=cuda_device)
    thresholds = gc.get_threshold()
    gc.set_threshold(1)
    try:
        got = CompiledSolver(drv, k=8, donate=False).solve(dropping_vf, y0, te, args=MU,
                                                           device=cuda_device)
    finally:
        gc.set_threshold(*thresholds)
    assert not box
    _bitwise(got, eager)


def test_scan_forward_reads_nothing(cuda_device):
    y0, te = _vdp_inputs()
    drv = ScanAdjoint(Stepper("dopri5"), rtol=1e-5, atol=1e-5, max_steps=45)
    with torch.no_grad():
        eager = drv.solve(vdp, y0, te, args=MU, device=cuda_device)
    solver = CompiledSolver(drv, k=16, donate=False)
    _bitwise(solver.solve(vdp, y0, te, args=MU, device=cuda_device), eager)
    runner = solver.compile(vdp, y0, te, args=MU, device=cuda_device).runner
    assert runner.reads == 0 and runner.replays == 3 and runner.sizes == [16, 13]


def test_max_steps_remainder(cuda_device):
    y0, te = _vdp_inputs()
    drv = AutoDiffAdjoint(Stepper("dopri5"), rtol=1e-7, atol=1e-7, max_steps=23)
    eager = drv.solve(vdp, y0, te, args=MU, device=cuda_device)
    assert torch.any(eager.status == Status.REACHED_MAX_STEPS.value)
    solver = CompiledSolver(drv, k=16, donate=False)
    _bitwise(solver.solve(vdp, y0, te, args=MU, device=cuda_device), eager)
    runner = solver.compile(vdp, y0, te, args=MU, device=cuda_device).runner
    assert sorted(runner.graphs) == [7, 16] and runner.replays == 2


def test_donated_final_state(cuda_device):
    y0, _ = _vdp_inputs()
    drv = AutoDiffAdjoint(Stepper("tsit5"), rtol=1e-6)
    want = drv.solve(vdp, y0, None, t_start=0.0, t_end=3.0, args=MU, device=cuda_device)
    y = torch.as_tensor(y0, device=cuda_device)
    sol = CompiledSolver(drv).solve(vdp, y, None, t_start=0.0, t_end=3.0, args=MU,
                                    device=cuda_device)
    assert sol.ys.data_ptr() == y.data_ptr() and torch.equal(y, want.ys)


def test_vector_field_that_syncs_makes_capture_raise(cuda_device):
    def syncing_vf(t, y, mu):
        if float(y.abs().max().item()) > 1e6:
            raise FloatingPointError("state blew up")
        return vdp(t, y, mu)

    y0, te = _vdp_inputs()
    solver = CompiledSolver(AutoDiffAdjoint(Stepper("dopri5"), rtol=1e-5), donate=False)
    with pytest.raises(RuntimeError, match="syncing_vf"):
        solver.solve(syncing_vf, y0, te, args=MU, device=cuda_device)
    # The card is usable afterwards, and a well-behaved vf captures.
    eager = AutoDiffAdjoint(Stepper("dopri5"), rtol=1e-5).solve(vdp, y0, te, args=MU,
                                                                 device=cuda_device)
    _bitwise(solver.solve(vdp, y0, te, args=MU, device=cuda_device), eager)


def test_sharded_two_streams_on_one_card(cuda_device):
    y0, te = _vdp_inputs(b=101)
    drv = AutoDiffAdjoint(Stepper("dopri5"), rtol=1e-5, atol=1e-5)
    want = CompiledSolver(drv, donate=False).solve(vdp, y0, te, args=MU, device=cuda_device)
    for _ in range(2):
        got = sharded_solve([cuda_device, cuda_device], vdp, y0, te, args=MU, solver=drv)
        assert got.ys.shape == want.ys.shape
        _bitwise(got, want, skip=("n_f_evals",))
