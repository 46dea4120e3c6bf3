"""The CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and skip without one; they import no JAX, so
they also run where only the port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_kernels_card.py

Tolerances: float32 at 1e-5 and float64 at 1e-12 -- fma contraction and
summation order only (the plain version's weighted sums go through cuBLAS).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import make_solver, solve_ivp  # noqa: E402
from repro_torch.kernels import cuda_impl, ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402


@pytest.fixture
def cuda_device():
    """The card, or a skip: these tests run the CUDA kernels themselves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


class TestKernelsOnCard:
    """Each CUDA kernel against its plain version on the same card tensors."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("shape", [(5, 3), (13, 300), (256, 2)])
    def test_all_four(self, cuda_device, dtype, shape):
        tol = 1e-5 if dtype == torch.float32 else 1e-12
        g = torch.Generator(device="cpu").manual_seed(0)
        b, f = shape

        def r(*s):
            return torch.randn(*s, generator=g, dtype=dtype).to(cuda_device)

        y, dt, K = r(b, f), r(b), r(7, b, f)
        c = np.random.default_rng(0).standard_normal(7)
        for j in range(1, 7):
            torch.testing.assert_close(cuda_impl.stage_accum(y, dt, K[:j], c[:j]),
                                       tref.stage_accum(y, dt, K[:j], c[:j]), rtol=tol, atol=tol)
        got = cuda_impl.fused_update(y, K, dt, c, c[::-1])
        for a, w in zip(got, tref.fused_update(y, K, dt, c, c[::-1])):
            torch.testing.assert_close(a, w, rtol=tol, atol=tol)
        err = 1e-4 * r(b, f)
        for atol, rtol in ((1e-6, 1e-3), (r(b).abs() + 1e-6, r(b).abs()),
                           (r(b, f).abs() + 1e-6, r(b, f).abs())):
            torch.testing.assert_close(cuda_impl.error_norm(err, y, K[0], atol, rtol),
                                       tref.error_norm(err, y, K[0], atol, rtol),
                                       rtol=tol, atol=tol)
        coeffs = tuple(r(b, f) for _ in range(4))
        x = torch.rand(b, 9, generator=g, dtype=dtype).to(cuda_device)
        mask = (torch.rand(b, 9, generator=g) < 0.3).to(cuda_device)
        out = r(b, 9, f)
        want = tref.interp_eval(coeffs, x, mask, out)
        torch.testing.assert_close(cuda_impl.interp_eval(coeffs, x, mask, out.clone()), want,
                                   rtol=tol, atol=tol)

    def test_window_write(self, cuda_device):
        g = torch.Generator(device="cpu").manual_seed(1)
        b, n, W, f = 7, 12, 4, 5
        coeffs = tuple(torch.randn(b, f, generator=g).to(cuda_device) for _ in range(4))
        x = torch.rand(b, W, generator=g).to(cuda_device)
        mask = (torch.rand(b, W, generator=g) < 0.5).to(cuda_device)
        out = torch.randn(b, n, f, generator=g).to(cuda_device)
        cursor = torch.randint(0, n - W + 1, (b,), generator=g).to(cuda_device)
        want = tref.interp_eval_window(coeffs, x, mask, out, cursor)
        torch.testing.assert_close(cuda_impl.interp_eval(coeffs, x, mask, out.clone(), cursor),
                                   want, rtol=1e-5, atol=1e-5)

    def test_window_past_the_buffer_is_not_written(self, cuda_device):
        b, n, W, f = 3, 6, 4, 2
        coeffs = tuple(torch.ones(b, f, device=cuda_device) for _ in range(4))
        x = torch.ones(b, W, device=cuda_device)
        mask = torch.ones(b, W, dtype=torch.bool, device=cuda_device)
        out = torch.zeros(b, n, f, device=cuda_device)
        cursor = torch.tensor([n - W, n - 1, -W], device=cuda_device)
        cuda_impl.interp_eval(coeffs, x, mask, out, cursor)
        written = (out != 0).all(dim=-1).cpu()
        assert written[0].tolist() == [False, False, True, True, True, True]
        assert written[1].tolist() == [False] * 5 + [True]
        assert not written[2].any()

    def test_requires_grad_raises(self, cuda_device):
        y = torch.ones(2, 3, device=cuda_device, requires_grad=True)
        with pytest.raises(RuntimeError, match="no backward"):
            cuda_impl.stage_accum(y, torch.ones(2, device=cuda_device),
                                  torch.ones(1, 2, 3, device=cuda_device), [1.0])


def test_solve_on_card_matches_cpu_and_counts_launches(cuda_device):
    """A float64 solve on the card takes the CPU's steps exactly, and goes
    through the kernels: (s - 1) stage_accum and one of each other kernel per
    iteration."""
    rng = np.random.default_rng(0)
    y0 = np.array([2.0, 0.0]) + 0.1 * rng.standard_normal((32, 2))
    te = np.linspace(0.0, 6.0, 40)

    def vdp(t, y, mu):
        return torch.stack((y[:, 1], mu * (1 - y[:, 0] ** 2) * y[:, 1] - y[:, 0]), dim=-1)

    for k in ops.launches:
        ops.launches[k] = 0
    card = solve_ivp(vdp, y0, te, args=2.0, atol=1e-6, rtol=1e-6, device=cuda_device)
    iters = int(card.stats["n_steps"].max())
    assert ops.launches == {"stage_accum": 6 * iters, "fused_update": iters,
                            "error_norm": iters, "interp_eval": iters}
    cpu = solve_ivp(vdp, y0, te, args=2.0, atol=1e-6, rtol=1e-6, device="cpu")
    assert torch.equal(card.stats["n_steps"].cpu(), cpu.stats["n_steps"])
    torch.testing.assert_close(card.ys.cpu(), cpu.ys, rtol=1e-9, atol=1e-9)


def test_step_writes_dense_output_in_place_on_card(cuda_device):
    """On the card ``step`` consumes the ``ys`` of the state it is given: the
    interp_eval kernel writes the passed eval points into that buffer and the
    new state holds the same tensor (on the CPU the old state keeps its
    ``ys``; ``tests/test_torch_core.py`` pins that)."""
    init, step, finish = make_solver(lambda t, y, a: -y, rtol=1e-6, atol=1e-8)
    state, consts = init(torch.ones(2, 1, dtype=torch.float64, device=cuda_device),
                         torch.linspace(0, 1, 9, dtype=torch.float64, device=cuda_device))
    wrote = False
    while bool(state.running.any()):
        old, before = state, state.ys.clone()
        state = step(old, consts, None)
        assert state.ys is old.ys
        wrote |= not torch.equal(old.ys, before)
    assert wrote
    torch.testing.assert_close(finish(state, consts).ys[:, -1, 0].cpu(),
                               torch.full((2,), np.exp(-1.0), dtype=torch.float64),
                               rtol=1e-6, atol=0)
