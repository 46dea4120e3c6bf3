"""The CUDA kernels against their plain versions, on the card, the fused
step kernels bitwise against the unfused card path (the row bodies of
``fused_step`` and ``fused_step_poly`` bitwise against their warp bodies
too), ``stage_accum`` and ``fused_update`` at every stage count on both of
their layouts (``fused_update`` with every tableau's weights too), the event
kernels bitwise
against their plain versions, and the chord-Newton kernels against theirs
(at a tolerance: LAPACK/cuSOLVER eliminate in another order) with the
unfused Newton iteration bitwise equal to the fused one.

These tests need a CUDA device and skip without one; they import no JAX, so
they also run where only the port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_kernels_card.py

Tolerances: float32 at 1e-5 and float64 at 1e-12 -- fma contraction and
summation order only (the plain version's weighted sums go through cuBLAS).
The event kernels and ``interp_eval`` round each operation as ATen does, so
they are held bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from unittest import mock  # noqa: E402

from repro_torch.core import (  # noqa: E402
    DiagonallyImplicitRK,
    Event,
    FixedController,
    get_tableau,
    integral_controller,
    make_solver,
    pid_controller,
    polynomial_term,
    solve_ivp,
)
from repro_torch.core.stepper import _tableau_arrays  # noqa: E402
from repro_torch.kernels import _build, cuda_impl, ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.tools import dense_checks, event_checks, grad_checks  # noqa: E402
from repro_torch.tools import newton_checks as NC  # noqa: E402
from repro_torch.tools.step_checks import (  # noqa: E402
    POLY32_STATE,
    bitwise_mismatches,
    hold_to_plain,
    ratio_floor,
    step_inputs,
    unfused_card,
)


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
                                   rtol=0, atol=0)

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
                            "error_norm": iters, "interp_eval": iters,
                            "fused_step": 0, "fused_step_poly": 0, "masked_bisect_refine": 0,
                            "fused_event_detect": 0, "fused_event_commit": 0,
                            "batched_linsolve": 0, "batched_lu_factor": 0,
                            "fused_newton_iter": 0, "masked_newton_update": 0,
                            "flash_attention_fwd": 0, "flash_attention_bwd": 0}
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


def _gen(seed):
    return torch.Generator(device="cpu").manual_seed(seed)


class TestFusedStepOnCard:
    """``fused_step`` and ``fused_step_poly`` against their plain versions
    (within 1e-5 / 1e-12) and, bitwise, against the unfused card path."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("shape", [(5, 3), (13, 300), (256, 2)])
    @pytest.mark.parametrize("ctrl_kind", ["integral", "pid", "fixed"])
    @pytest.mark.parametrize("tol_kind", ["scalar", "row", "full"])
    def test_fused_step(self, cuda_device, dtype, shape, ctrl_kind, tol_kind):
        b, f = shape
        tab = get_tableau("rk4" if ctrl_kind == "fixed" else "dopri5")
        ctl = {"integral": integral_controller(), "pid": pid_controller(),
               "fixed": FixedController()}[ctrl_kind]
        _, _, b_sol, b_err = _tableau_arrays(tab, dtype)
        y, K, cols, failed = step_inputs(b, f, tab.stages, dtype, cuda_device, _gen(b + f))
        fac = 1.0 if tol_kind == "scalar" else 1.0 + torch.rand(
            (b,) if tol_kind == "row" else (b, f), dtype=dtype).to(cuda_device)
        for want_coeffs in (True, False):
            for fail in (None, failed):
                kw = dict(b_sol=b_sol, b_err=b_err, ctrl=ctl.filter_params(tab.error_order),
                          want_coeffs=want_coeffs, failed=fail,
                          ctrl_mode="fixed" if ctrl_kind == "fixed" else "pid")
                args = (y, K, K[-1], *cols, 0.01 * fac, 1e-3 * fac)
                got = cuda_impl.fused_step(*args, **kw)
                assert bitwise_mismatches(
                    got, unfused_card(lambda: tref.fused_step(*args, **kw))) == {}
                # Under autograd the launch also writes the error estimate:
                # the same outputs, the estimate fused_update's bits.
                for body in cuda_impl.STEP_BODIES:
                    errs = torch.full_like(y, float("nan"))
                    again = cuda_impl.fused_step(*args, errs=errs, body=body, **kw)
                    assert bitwise_mismatches(again, got) == {}
                    assert torch.equal(errs, cuda_impl.fused_update(y, K, cols[3], b_sol,
                                                                    b_err)[1]), body
                want = tref.fused_step(*args, **kw)
                hold_to_plain("fused_step", got, want, ratio_floor(
                    y, want[0], K, cols[3], b_err, 0.01 * fac, 1e-3 * fac))
                if fail is not None:
                    assert not bool(got[2][fail].any())
                    assert bool(torch.isinf(got[1][fail]).all())

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("shape", [(5, 3), (13, 300)])
    @pytest.mark.parametrize("method", ["dopri5", "heun", "rk4", "euler"])
    @pytest.mark.parametrize("poly", ["logistic", "per_feature", "constant"])
    def test_fused_step_poly(self, cuda_device, dtype, shape, method, poly):
        b, f = shape
        tab = get_tableau(method)
        adaptive = tab.b_err is not None
        ctl = pid_controller() if adaptive else FixedController()
        a, c, b_sol, b_err = _tableau_arrays(tab, dtype)
        coeffs = {"logistic": (0.0, 1.0, -1.0),
                  "per_feature": (0.5, tuple(np.linspace(-1.5, -0.5, f).tolist())),
                  "constant": (0.25,)}[poly]
        y, _, cols, _ = step_inputs(b, f, tab.stages, dtype, cuda_device, _gen(b + f), 4.0)
        f0 = tref.poly_eval(y, coeffs)
        for want_coeffs in (True, False):
            kw = dict(a=a, c=c, b_sol=b_sol, b_err=b_err, poly=coeffs,
                      ctrl=ctl.filter_params(tab.error_order), want_coeffs=want_coeffs,
                      fsal=tab.fsal, ctrl_mode="pid" if adaptive else "fixed")
            args = (y, f0, *cols, 1e-4, 1e-3)
            got = cuda_impl.fused_step_poly(*args, **kw)
            assert bitwise_mismatches(
                got, unfused_card(lambda: tref.fused_step_poly(*args, **kw))) == {}
            want = tref.fused_step_poly(*args, **kw)
            K = tref.poly_stages(y, f0, cols[3], a, coeffs)
            hold_to_plain("fused_step_poly", got, want,
                          ratio_floor(y, want[0], K, cols[3], b_err, 1e-4, 1e-3),
                          POLY32_STATE if dtype == torch.float32 else None)
            # Under autograd the launch also writes its stages, their
            # arguments and the error estimate: the same outputs bitwise, and
            # those bitwise the unfused card path's.
            s = tab.stages
            stages = torch.empty((s, b, f), dtype=dtype, device=cuda_device)
            zs = torch.empty((s - 1, b, f), dtype=dtype, device=cuda_device)
            errs = torch.empty((b, f), dtype=dtype, device=cuda_device)
            K = unfused_card(lambda: tref.poly_stages(y, f0, cols[3], a, coeffs))
            Z = [cuda_impl.stage_accum(y, cols[3], K[:i].contiguous(), a[i, :i])
                 for i in range(1, s)]
            err = cuda_impl.fused_update(y, K, cols[3], b_sol, b_err)[1]
            for body in cuda_impl.POLY_BODIES:
                for out in (stages, zs, errs):
                    out.fill_(float("nan"))
                again = cuda_impl.fused_step_poly(*args, stages=stages, stage_args=zs,
                                                  errs=errs, body=body, **kw)
                assert bitwise_mismatches(again, cuda_impl.fused_step_poly(
                    *args, body=body, **kw)) == {}
                assert torch.equal(stages, K) and torch.equal(errs, err), body
                assert all(torch.equal(zs[i], z) for i, z in enumerate(Z)), body


# fused_step_poly's widths: the narrow vdp-like rows, around a warp (31, 33)
# and around step_bench's 784 (whole 16-byte chunks or not); test_widest_row
# takes the widest row body and the first width past it.
POLY_WIDTHS = (1, 2, 31, 33, 783, 784, 785)
POLY_COEFFS = {"logistic": (0.0, 1.0, -1.0), "constant": (0.25,),
               # degree 5: the row body reads these from device memory
               "quintic": (0.1, -1.0, 0.5, -0.25, 0.05, -0.01)}
POLY_METHODS = {"dopri5": "pid", "heun": "pid", "rk4": "fixed", "euler": "fixed"}


def _poly_case(device, dtype, b, f, method, poly, seed):
    """Inputs of one fused_step_poly call: ``(y, f0, cols)`` and the keyword
    arguments but ``want_coeffs``."""
    tab = get_tableau(method)
    mode = POLY_METHODS[method]
    ctl = pid_controller() if mode == "pid" else FixedController()
    a, c, b_sol, b_err = _tableau_arrays(tab, dtype)
    coeffs = (POLY_COEFFS[poly] if poly != "per_feature"
              else (0.5, tuple(np.linspace(-1.5, -0.5, f).tolist())))
    y, _, cols, _ = step_inputs(b, f, tab.stages, dtype, device, _gen(seed), 4.0)
    f0 = tref.poly_eval(y, coeffs)
    kw = dict(a=a, c=c, b_sol=b_sol, b_err=b_err, poly=coeffs,
              ctrl=ctl.filter_params(tab.error_order), fsal=tab.fsal, ctrl_mode=mode)
    return y, f0, cols, kw


def _hold_poly_bodies(y, f0, cols, kw, tols):
    """The row body bitwise equal to the warp body and to the unfused card
    path, and held to the plain version, for each (atol, rtol) of ``tols``,
    with and without the Hermite coefficients; each body counted."""
    for atol, rtol in tols:
        for want_coeffs in (True, False):
            args = (y, f0, *cols, atol, rtol)
            kwc = dict(kw, want_coeffs=want_coeffs)
            before = dict(cuda_impl.body_launches["fused_step_poly"])
            row = cuda_impl.fused_step_poly(*args, body="row", **kwc)
            warp = cuda_impl.fused_step_poly(*args, body="warp", **kwc)
            assert cuda_impl.body_launches["fused_step_poly"] == {
                "warp": before["warp"] + 1, "row": before["row"] + 1}
            assert bitwise_mismatches(row, warp) == {}
            assert bitwise_mismatches(
                row, unfused_card(lambda: tref.fused_step_poly(*args, **kwc))) == {}
            want = tref.fused_step_poly(*args, **kwc)
            K = tref.poly_stages(y, f0, cols[3], kw["a"], kw["poly"])
            hold_to_plain("fused_step_poly", row, want,
                          ratio_floor(y, want[0], K, cols[3], kw["b_err"], atol, rtol),
                          POLY32_STATE if y.dtype == torch.float32 else None)


def _tol_shapes(b, f, dtype, device):
    """A scalar, a (b,) and a (b, f) tolerance pair."""
    g = _gen(b * f)

    def fac(*shape):
        return (1.0 + torch.rand(*shape, generator=g, dtype=dtype)).to(device)

    return ((1e-4, 1e-3), (1e-4 * fac(b), 1e-3 * fac(b)), (1e-4 * fac(b, f), 1e-3 * fac(b, f)))


class TestFusedStepPolyBodies:
    """``fused_step_poly``'s row body against its warp body, the unfused card
    path (both bitwise) and the plain version, over the widths at the
    boundaries of its layout, FSAL and non-FSAL tableaus, the PID and fixed
    controllers, scalar, per-feature and degree-5 polynomials, mixed running
    rows and every tolerance shape."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("f", POLY_WIDTHS)
    @pytest.mark.parametrize("method", list(POLY_METHODS))
    @pytest.mark.parametrize("poly", ["logistic", "per_feature", "constant", "quintic"])
    def test_row_equals_warp(self, cuda_device, dtype, f, method, poly):
        b = 37
        y, f0, cols, kw = _poly_case(cuda_device, dtype, b, f, method, poly, b + f)
        _hold_poly_bodies(y, f0, cols, kw, _tol_shapes(b, f, dtype, cuda_device))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("f", [33, 784])
    @pytest.mark.parametrize("plane", ["y", "f0"])
    def test_unaligned_planes(self, cuda_device, dtype, f, plane):
        """A plane one entry past a 16-byte boundary: entry by entry."""
        b = 37
        y, f0, cols, kw = _poly_case(cuda_device, dtype, b, f, "dopri5", "logistic", f)
        if plane == "y":
            y = event_checks.unaligned(y)
        else:
            f0 = event_checks.unaligned(f0)
        _hold_poly_bodies(y, f0, cols, kw, _tol_shapes(b, f, dtype, cuda_device))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_widest_row(self, cuda_device, dtype):
        """The widest f whose row fits the device's shared memory takes the
        row body by default; one more takes the warp body, and the row body
        is refused before the launch."""
        lib = _build.load()
        itemsize = torch.empty((), dtype=dtype).element_size()
        limit = lib.rt_fused_step_max_smem()
        f = max(w for w in range(1, limit) if cuda_impl.row_smem_bytes(w, itemsize) <= limit)
        for width, body in ((f, "row"), (f + 1, "warp")):
            assert cuda_impl.fused_step_poly_body(width, itemsize, limit) == body
            y, f0, cols, kw = _poly_case(cuda_device, dtype, 3, width, "dopri5", "logistic", 3)
            before = dict(cuda_impl.body_launches["fused_step_poly"])
            cuda_impl.fused_step_poly(y, f0, *cols, 1e-4, 1e-3, want_coeffs=True, **kw)
            assert cuda_impl.body_launches["fused_step_poly"][body] == before[body] + 1
            if body == "row":
                _hold_poly_bodies(y, f0, cols, kw, [(1e-4, 1e-3)])
            else:
                with pytest.raises(ValueError, match="the row body needs"):
                    cuda_impl.fused_step_poly(y, f0, *cols, 1e-4, 1e-3, want_coeffs=True,
                                              body="row", **kw)


# fused_step's widths: one entry, the narrow vdp / robertson rows, a row
# narrower than a float32 chunk's multiple, a warp, allen_cahn_full's 128 and
# full_width's 784; test_widest_row takes the widest row body.
STEP_WIDTHS = (1, 2, 3, 5, 32, 128, 784)
# Tableau -> controller mode: FSAL and adaptive, non-FSAL and adaptive (f1 a
# plane of its own), fixed, and the stiff path's (the fused DIRK step passes
# failed and f0).
STEP_METHODS = {"dopri5": "pid", "heun": "pid", "rk4": "fixed", "kvaerno5": "pid"}


def _step_case(device, dtype, b, f, method, seed):
    """Inputs of one fused_step call: ``(y, K, f1, cols, failed, f0)`` and
    the keyword arguments but ``want_coeffs``, ``failed`` and ``f0``.  f1 is
    K[-1] for an FSAL tableau, else a plane of its own."""
    tab = get_tableau(method)
    mode = STEP_METHODS[method]
    ctl = pid_controller() if mode == "pid" else FixedController()
    _, _, b_sol, b_err = _tableau_arrays(tab, dtype)
    g = _gen(seed)
    y, K, cols, failed = step_inputs(b, f, tab.stages, dtype, device, g)
    f1 = K[-1] if tab.fsal else torch.randn(b, f, generator=g, dtype=dtype).to(device)
    f0 = torch.randn(b, f, generator=g, dtype=dtype).to(device)
    kw = dict(b_sol=b_sol, b_err=b_err, ctrl=ctl.filter_params(tab.error_order),
              ctrl_mode=mode)
    return y, K, f1, cols, failed, f0, kw


def _hold_step_bodies(y, K, f1, cols, kw, tols, extras):
    """fused_step's row body bitwise equal to its warp body and to the
    unfused card path, and held to the plain version, for each (atol, rtol)
    of ``tols`` and each ``(failed, f0)`` of ``extras``, with and without the
    Hermite coefficients; each body counted."""
    for (atol, rtol), (failed, f0) in ((t, e) for t in tols for e in extras):
        for want_coeffs in (True, False):
            args = (y, K, f1, *cols, atol, rtol)
            kwc = dict(kw, want_coeffs=want_coeffs, failed=failed, f0=f0)
            before = dict(cuda_impl.body_launches["fused_step"])
            row = cuda_impl.fused_step(*args, body="row", **kwc)
            warp = cuda_impl.fused_step(*args, body="warp", **kwc)
            assert cuda_impl.body_launches["fused_step"] == {
                "warp": before["warp"] + 1, "row": before["row"] + 1}
            assert bitwise_mismatches(row, warp) == {}
            assert bitwise_mismatches(
                row, unfused_card(lambda: tref.fused_step(*args, **kwc))) == {}
            want = tref.fused_step(*args, **kwc)
            hold_to_plain("fused_step", row, want,
                          ratio_floor(y, want[0], K, cols[3], kw["b_err"], atol, rtol))
            if failed is not None:
                assert not bool(row[2][failed].any())


class TestFusedStepBodies:
    """``fused_step``'s row body against its warp body, the unfused card path
    (both bitwise) and the plain version: at the widths around its layout,
    FSAL (f1 = K[-1], read once) and non-FSAL tableaus, the PID and fixed
    controllers, ``failed`` and ``f0`` null and set, every tolerance shape,
    coefficients on and off, and planes off a 16-byte boundary."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("f", STEP_WIDTHS)
    @pytest.mark.parametrize("method", list(STEP_METHODS))
    def test_row_equals_warp(self, cuda_device, dtype, f, method):
        b = 37
        y, K, f1, cols, failed, f0, kw = _step_case(cuda_device, dtype, b, f, method, b + f)
        _hold_step_bodies(y, K, f1, cols, kw, _tol_shapes(b, f, dtype, cuda_device),
                          ((None, None), (failed, None), (failed, f0)))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("f", [33, 784])
    @pytest.mark.parametrize("plane", ["y", "K", "f1", "f0"])
    def test_unaligned_planes(self, cuda_device, dtype, f, plane):
        """A plane one entry past a 16-byte boundary: entry by entry."""
        b = 37
        y, K, f1, cols, failed, f0, kw = _step_case(cuda_device, dtype, b, f, "heun", f)
        if plane == "y":
            y = event_checks.unaligned(y)
        elif plane == "K":
            K = event_checks.unaligned(K)
        elif plane == "f1":
            f1 = event_checks.unaligned(f1)
        else:
            f0 = event_checks.unaligned(f0)
        _hold_step_bodies(y, K, f1, cols, kw, _tol_shapes(b, f, dtype, cuda_device),
                          ((failed, f0),))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_widest_row(self, cuda_device, dtype):
        """The widest f whose row fits takes the row body by default; one
        more takes the warp body, and the row body is refused before the
        launch."""
        lib = _build.load()
        itemsize = torch.empty((), dtype=dtype).element_size()
        limit = lib.rt_fused_step_max_smem()
        f = max(w for w in range(1, limit) if cuda_impl.row_smem_bytes(w, itemsize) <= limit)
        for width, body in ((f, "row"), (f + 1, "warp")):
            assert cuda_impl.fused_step_body(width, itemsize, limit) == body
            y, K, f1, cols, failed, f0, kw = _step_case(cuda_device, dtype, 3, width,
                                                        "dopri5", 3)
            before = dict(cuda_impl.body_launches["fused_step"])
            cuda_impl.fused_step(y, K, f1, *cols, 1e-4, 1e-3, want_coeffs=True, **kw)
            assert cuda_impl.body_launches["fused_step"][body] == before[body] + 1
            if body == "row":
                _hold_step_bodies(y, K, f1, cols, kw, [(1e-4, 1e-3)],
                                  ((None, None), (failed, f0)))
            else:
                with pytest.raises(ValueError, match="the row body needs"):
                    cuda_impl.fused_step(y, K, f1, *cols, 1e-4, 1e-3, want_coeffs=True,
                                         body="row", **kw)

    def test_entry_refuses_an_unknown_body(self, cuda_device):
        y, K, f1, cols, _, _, kw = _step_case(cuda_device, torch.float32, 3, 8, "dopri5", 1)
        with pytest.raises(ValueError, match="unknown body"):
            cuda_impl.fused_step(y, K, f1, *cols, 1e-4, 1e-3, want_coeffs=False, body="block",
                                 **kw)
        args = cuda_impl._FusedStepArgs()
        stream = cuda_impl._stream(cuda_device)
        assert _build.load().rt_fused_step(0, 2, cuda_impl.ctypes.byref(args), stream) != 0


class TestStageAccumOnCard:
    """``stage_accum`` against its plain version at every stage count its
    entry instantiates from a tableau (j = 1..7), on its 16-byte chunks and
    entry by entry (odd f, y or K off a 16-byte boundary), with rows
    narrower than a warp sharing a block."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("b, f", [(5, 1), (300, 2), (37, 3), (37, 33), (37, 783),
                                      (37, 784), (37, 785), (3, 5000)])
    @pytest.mark.parametrize("layout", ["aligned", "y", "K"])
    def test_against_plain(self, cuda_device, dtype, b, f, layout):
        tol = 1e-5 if dtype == torch.float32 else 1e-12
        g = _gen(b * f)
        y = torch.randn(b, f, generator=g, dtype=dtype).to(cuda_device)
        dt = torch.rand(b, generator=g, dtype=dtype).to(cuda_device)
        K = torch.randn(7, b, f, generator=g, dtype=dtype).to(cuda_device)
        a = np.random.default_rng(f).standard_normal(7)
        if layout == "y":
            y = event_checks.unaligned(y)
        for j in range(1, 8):
            Kj = event_checks.unaligned(K[:j]) if layout == "K" else K[:j]
            torch.testing.assert_close(cuda_impl.stage_accum(y, dt, Kj, a[:j]),
                                       tref.stage_accum(y, dt, Kj, a[:j]), rtol=tol, atol=tol)

    def test_entry_refuses_a_stage_count(self, cuda_device):
        y = torch.ones(2, 4, device=cuda_device)
        lib = _build.load()
        arr = (cuda_impl.ctypes.c_double * 9)(*([1.0] * 9))
        for nj in (0, 9):
            assert lib.rt_stage_accum(0, y.data_ptr(), y.data_ptr(), y.data_ptr(), arr, nj,
                                      y.data_ptr(), 2, 4, cuda_impl._stream(cuda_device)) != 0


class TestFusedUpdateOnCard:
    """``fused_update`` against its plain version at every stage count its
    entry instantiates (1..8) and with every tableau's weights, zero weights
    included (``dense_checks.UPDATE_WEIGHTS``), at the widths around its
    layout (``dense_checks.UPDATE_SHAPES``), on its 16-byte chunks and entry
    by entry (y or K off a 16-byte boundary)."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("b, f", dense_checks.UPDATE_SHAPES)
    @pytest.mark.parametrize("layout", ["aligned", "y", "K"])
    def test_against_plain(self, cuda_device, dtype, b, f, layout):
        tol = 1e-5 if dtype == torch.float32 else 1e-12
        npdt = np.float32 if dtype == torch.float32 else np.float64
        for weights in dense_checks.UPDATE_WEIGHTS:
            b_sol, b_err = dense_checks.update_weights(weights)
            y, K, dt = (torch.from_numpy(a).to(cuda_device) for a in dense_checks.update_inputs(
                b * f + len(b_sol), b, f, len(b_sol), npdt))
            if layout == "y":
                y = event_checks.unaligned(y)
            elif layout == "K":
                K = event_checks.unaligned(K)
            got = cuda_impl.fused_update(y, K, dt, b_sol, b_err)
            for g, w in zip(got, tref.fused_update(y, K, dt, b_sol, b_err)):
                torch.testing.assert_close(g, w, rtol=tol, atol=tol,
                                           msg=lambda m, weights=weights: f"{weights}: {m}")

    @pytest.mark.parametrize("b, f", [(0, 784), (0, 2), (5, 0)])
    def test_empty_is_one_counted_launch(self, cuda_device, b, f):
        y, K, dt = (torch.ones(s, device=cuda_device) for s in ((b, f), (7, b, f), (b,)))
        before = ops.launches["fused_update"]
        y1, err = cuda_impl.fused_update(y, K, dt, [1.0] * 7, [0.5] * 7)
        torch.cuda.synchronize()
        assert y1.shape == err.shape == (b, f)
        assert ops.launches["fused_update"] == before + 1

    def test_entry_refuses_a_stage_count_or_a_size(self, cuda_device):
        """Before any launch: a stage count outside 1..8, or b or f above
        2^31 - 1 (the kernel indexes a row in 32 bits)."""
        y = torch.ones(2, 4, device=cuda_device)
        lib = _build.load()
        arr = (cuda_impl.ctypes.c_double * 9)(*([1.0] * 9))
        p, stream = y.data_ptr(), cuda_impl._stream(cuda_device)
        for ns, b, f in ((0, 2, 4), (9, 2, 4), (1, 2**31, 4), (1, 2, 2**31)):
            assert lib.rt_fused_update(0, p, p, p, arr, arr, ns, p, p, b, f, stream) != 0
        y1, err = torch.empty_like(y), torch.empty_like(y)
        assert lib.rt_fused_update(0, p, p, p, arr, arr, 1, y1.data_ptr(), err.data_ptr(), 2, 4,
                                   stream) == 0
        torch.testing.assert_close(y1, torch.full_like(y, 2.0))


def _dense_tensors(arrays, device):
    """numpy arrays (and tuples of them) -> tensors on ``device``; numbers
    pass as they are."""
    if isinstance(arrays, tuple):
        return tuple(_dense_tensors(a, device) for a in arrays)
    return torch.from_numpy(arrays).to(device) if isinstance(arrays, np.ndarray) else arrays


class TestErrorNormOnCard:
    """``error_norm``'s three bodies against the plain version, bitwise to
    each other, and bitwise to the ratio the fused step computes: at the
    widths around its layout (``dense_checks.ERROR_NORM_WIDTHS``: rows
    sharing a block, a warp, whole 16-byte chunks or not), every tolerance
    shape, and with a plane one entry off a 16-byte boundary (entry by
    entry); the wide body also at its own widths
    (``dense_checks.NORM_WIDE_WIDTHS`` x ``NORM_WIDE_ROWS``)."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("f", dense_checks.ERROR_NORM_WIDTHS)
    @pytest.mark.parametrize("tol_kind", dense_checks.TOL_KINDS)
    @pytest.mark.parametrize("layout", ["aligned", "err", "y1", "tol"])
    def test_widths(self, cuda_device, dtype, f, tol_kind, layout):
        tol = 1e-5 if dtype == torch.float32 else 1e-12
        npdt = np.float32 if dtype == torch.float32 else np.float64
        err, y0, y1, atol, rtol = _dense_tensors(
            dense_checks.norm_inputs(f, 37, f, npdt, tol_kind), cuda_device)
        if layout in ("err", "y1"):
            err, y1 = (event_checks.unaligned(t) if layout == name else t
                       for t, name in ((err, "err"), (y1, "y1")))
        elif layout == "tol" and tol_kind != "scalar":
            atol = event_checks.unaligned(atol)
        want = tref.error_norm(err, y0, y1, atol, rtol)
        got = {}
        for body in cuda_impl.ERROR_NORM_BODIES:
            before = cuda_impl.body_launches["error_norm"][body]
            got[body] = cuda_impl.error_norm(err, y0, y1, atol, rtol, body=body)
            assert cuda_impl.body_launches["error_norm"][body] == before + 1
            torch.testing.assert_close(got[body], want, rtol=tol, atol=tol)
        assert torch.equal(got["row"], got["warp"])
        assert torch.equal(got["wide"], got["warp"])

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("f", dense_checks.ERROR_NORM_WIDTHS)
    @pytest.mark.parametrize("layout", ["aligned", "y"])
    def test_fused_ratio_bitwise(self, cuda_device, dtype, f, layout):
        """Each body, patched into the unfused card path, gives bitwise the
        err_ratio of both of fused_step's bodies on the same step inputs."""
        b = 37
        y, K, f1, cols, _, _, kw = _step_case(cuda_device, dtype, b, f, "dopri5", b + f)
        if layout == "y":
            y = event_checks.unaligned(y)
        kw = dict(kw, want_coeffs=False)
        for atol, rtol in _tol_shapes(b, f, dtype, cuda_device):
            args = (y, K, f1, *cols, atol, rtol)
            fused = [cuda_impl.fused_step(*args, body=body, **kw)[1]
                     for body in cuda_impl.STEP_BODIES]
            for norm_body in cuda_impl.ERROR_NORM_BODIES:
                def unfused(norm_body=norm_body):
                    norm = lambda *a: cuda_impl.error_norm(*a, body=norm_body)  # noqa: E731
                    with mock.patch.object(tref, "error_norm", norm):
                        return tref.fused_step(*args, **kw)

                ratio = unfused_card(unfused)[1]
                for got in fused:
                    assert torch.equal(got, ratio), norm_body

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("f", dense_checks.NORM_WIDE_WIDTHS)
    @pytest.mark.parametrize("b", dense_checks.NORM_WIDE_ROWS)
    @pytest.mark.parametrize("tol_kind", dense_checks.TOL_KINDS)
    def test_wide_body_bitwise(self, cuda_device, dtype, f, b, tol_kind):
        """The wide body, chosen by ``error_norm_body``, bitwise to the warp
        body and within rounding of the plain version."""
        tol = 1e-5 if dtype == torch.float32 else 1e-12
        npdt = np.float32 if dtype == torch.float32 else np.float64
        args = _dense_tensors(dense_checks.norm_inputs(f + b, b, f, npdt, tol_kind),
                              cuda_device)
        assert cuda_impl.error_norm_body(f) == "wide"
        before = cuda_impl.body_launches["error_norm"]["wide"]
        wide = cuda_impl.error_norm(*args)
        assert cuda_impl.body_launches["error_norm"]["wide"] == before + 1
        assert torch.equal(wide, cuda_impl.error_norm(*args, body="warp"))
        torch.testing.assert_close(wide, tref.error_norm(*args), rtol=tol, atol=tol)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("f", [4097, 9001])
    def test_wide_body_fused_ratio_bitwise(self, cuda_device, dtype, f):
        """The wide body patched into the unfused card path gives bitwise the
        err_ratio of both of fused_step's bodies."""
        b = 37
        y, K, f1, cols, _, _, kw = _step_case(cuda_device, dtype, b, f, "dopri5", b + f)
        kw = dict(kw, want_coeffs=False)
        for atol, rtol in _tol_shapes(b, f, dtype, cuda_device):
            args = (y, K, f1, *cols, atol, rtol)
            fused = [cuda_impl.fused_step(*args, body=body, **kw)[1]
                     for body in cuda_impl.STEP_BODIES]

            def unfused():
                norm = lambda *a: cuda_impl.error_norm(*a, body="wide")  # noqa: E731
                with mock.patch.object(tref, "error_norm", norm):
                    return tref.fused_step(*args, **kw)

            ratio = unfused_card(unfused)[1]
            for got in fused:
                assert torch.equal(got, ratio)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("tol_kind", dense_checks.TOL_KINDS)
    def test_widest_rows(self, cuda_device, dtype, tol_kind):
        """At ``NORM_ROW_MAX_F`` entries (the widest row the row body holds in
        shared memory) the three bodies give the same bits; one entry wider,
        and at 9001, the wide body runs, bitwise the warp body's, and the row
        body is refused, by the wrapper before any launch and by the C
        entry."""
        tol = 1e-5 if dtype == torch.float32 else 1e-12
        npdt = np.float32 if dtype == torch.float32 else np.float64
        for f in (cuda_impl.NORM_ROW_MAX_F, cuda_impl.NORM_ROW_MAX_F + 1, 9001):
            args = _dense_tensors(dense_checks.norm_inputs(f, 3, f, npdt, tol_kind),
                                  cuda_device)
            want = tref.error_norm(*args)
            warp = cuda_impl.error_norm(*args, body="warp")
            torch.testing.assert_close(warp, want, rtol=tol, atol=tol)
            assert torch.equal(cuda_impl.error_norm(*args, body="wide"), warp)
            if f <= cuda_impl.NORM_ROW_MAX_F:
                assert torch.equal(cuda_impl.error_norm(*args, body="row"), warp)
                continue
            before = dict(cuda_impl.launches)
            with pytest.raises(ValueError, match="row body"):
                cuda_impl.error_norm(*args, body="row")
            assert cuda_impl.launches == before
            wide = cuda_impl.body_launches["error_norm"]["wide"]
            assert torch.equal(cuda_impl.error_norm(*args), warp)
            assert cuda_impl.body_launches["error_norm"]["wide"] == wide + 1
        y = torch.ones(2, cuda_impl.NORM_ROW_MAX_F + 1, device=cuda_device)
        lib, stream = _build.load(), cuda_impl._stream(cuda_device)
        assert lib.rt_error_norm(
            0, cuda_impl.ERROR_NORM_BODIES["row"], y.data_ptr(), y.data_ptr(), y.data_ptr(),
            None, 1e-6, 0, 0, None, 1e-3, 0, 0, None, y.data_ptr(), 2, y.shape[1], stream) != 0
        # the wide body without its scratch
        assert lib.rt_error_norm(
            0, cuda_impl.ERROR_NORM_BODIES["wide"], y.data_ptr(), y.data_ptr(), y.data_ptr(),
            None, 1e-6, 0, 0, None, 1e-3, 0, 0, None, y.data_ptr(), 2, y.shape[1], stream) != 0

    def test_entry_refuses_an_unknown_body(self, cuda_device):
        y = torch.ones(2, 4, device=cuda_device)
        with pytest.raises(ValueError, match="unknown body"):
            cuda_impl.error_norm(y, y, y, 1e-6, 1e-3, body="block")
        lib = _build.load()
        assert lib.rt_error_norm(0, len(cuda_impl.ERROR_NORM_BODIES), y.data_ptr(),
                                 y.data_ptr(), y.data_ptr(), None, 1e-6, 0, 0, None, 1e-3, 0, 0,
                                 None, y.data_ptr(), 2, 4, cuda_impl._stream(cuda_device)) != 0


def _interp_case(device, dtype, b, n, f, kind, seed):
    npdt = np.float32 if dtype == torch.float32 else np.float64
    coeffs, x, mask, out = dense_checks.interp_inputs(seed, b, n, f, npdt, kind)
    return (_dense_tensors(coeffs, device), *_dense_tensors((x, mask, out), device))


class TestInterpEvalOnCard:
    """``interp_eval``'s two bodies bitwise against the plain version on a
    copy of ``out`` (so a write to an unmasked cell shows): at
    ``dense_checks.ERROR_NORM_WIDTHS``, every mask kind (none, one point, all,
    3 consecutive, rows with none between rows with some), more points than
    one ballot round (n = 300), planes off a 16-byte boundary, and the
    windowed form with cursors at 0, n - W and past either end of the
    buffer."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("f", dense_checks.ERROR_NORM_WIDTHS)
    @pytest.mark.parametrize("kind", dense_checks.MASK_KINDS)
    @pytest.mark.parametrize("body", list(cuda_impl.INTERP_BODIES))
    def test_widths(self, cuda_device, dtype, f, kind, body):
        coeffs, x, mask, out = _interp_case(cuda_device, dtype, 37, 40, f, kind, f)
        want = tref.interp_eval(coeffs, x, mask, out)
        before = cuda_impl.body_launches["interp_eval"][body]
        got = cuda_impl.interp_eval(coeffs, x, mask, out.clone(), body=body)
        assert cuda_impl.body_launches["interp_eval"][body] == before + 1
        assert torch.equal(got, want)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("f", [2, 33, 784])
    @pytest.mark.parametrize("kind", ["run3", "all", "some_rows"])
    def test_more_points_than_a_ballot_round(self, cuda_device, dtype, f, kind):
        coeffs, x, mask, out = _interp_case(cuda_device, dtype, 5, 300, f, kind, f)
        want = tref.interp_eval(coeffs, x, mask, out)
        for body in cuda_impl.INTERP_BODIES:
            assert torch.equal(cuda_impl.interp_eval(coeffs, x, mask, out.clone(), body=body),
                               want)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("f", [4, 783, 784])
    @pytest.mark.parametrize("plane", ["out", "c0", "c3"])
    def test_unaligned_planes(self, cuda_device, dtype, f, plane):
        coeffs, x, mask, out = _interp_case(cuda_device, dtype, 37, 40, f, "run3", f)
        if plane == "c0":
            coeffs = (event_checks.unaligned(coeffs[0]),) + coeffs[1:]
        elif plane == "c3":
            coeffs = coeffs[:3] + (event_checks.unaligned(coeffs[3]),)
        want = tref.interp_eval(coeffs, x, mask, out)
        for body in cuda_impl.INTERP_BODIES:
            got = event_checks.unaligned(out) if plane == "out" else out.clone()
            assert torch.equal(cuda_impl.interp_eval(coeffs, x, mask, got, body=body), want)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("f", dense_checks.ERROR_NORM_WIDTHS)
    @pytest.mark.parametrize("body", list(cuda_impl.INTERP_BODIES))
    def test_window(self, cuda_device, dtype, f, body):
        """Cursors at 0 and n - W against ``ref.interp_eval_window``; cursors
        past either end write only the cells inside the buffer."""
        b, n, W = 6, 20, 8
        coeffs, x, mask, out = _interp_case(cuda_device, dtype, b, W, f, "all", f)
        mask[::2] = torch.from_numpy(dense_checks.interp_mask(f, 3, W, "run3")).to(cuda_device)
        out = torch.randn(b, n, f, generator=_gen(f), dtype=dtype).to(cuda_device)
        inside = torch.tensor([0, n - W, 0, n - W, 5, n - W], device=cuda_device)
        want = tref.interp_eval_window(coeffs, x, mask, out, inside)
        got = cuda_impl.interp_eval(coeffs, x, mask, out.clone(), inside, body=body)
        assert torch.equal(got, want)
        past = torch.tensor([n - W + 3, n - 1, n, -3, -W, 2 * n], device=cuda_device)
        values = tref.interp_eval(coeffs, x, torch.ones_like(mask),
                                  torch.zeros(b, W, f, dtype=dtype, device=cuda_device))
        want = out.clone()
        for r in range(b):
            for w in range(W):
                col = int(past[r]) + w
                if 0 <= col < n and bool(mask[r, w]):
                    want[r, col] = values[r, w]
        got = cuda_impl.interp_eval(coeffs, x, mask, out.clone(), past, body=body)
        assert torch.equal(got, want)

    def test_entry_refuses_an_unknown_body(self, cuda_device):
        coeffs, x, mask, out = _interp_case(cuda_device, torch.float32, 2, 4, 3, "all", 0)
        with pytest.raises(ValueError, match="unknown body"):
            cuda_impl.interp_eval(coeffs, x, mask, out, body="warp")
        lib = _build.load()
        assert lib.rt_interp_eval(0, 2, *(c.data_ptr() for c in coeffs), x.data_ptr(),
                                  mask.data_ptr(), None, out.data_ptr(), 2, 4, 4, 3,
                                  cuda_impl._stream(cuda_device)) != 0


@pytest.mark.parametrize("method", ["dopri5", "tsit5", "heun"])
def test_fused_solve_counts_launches_and_matches_unfused(cuda_device, method):
    """A float64 fused solve takes the unfused solve's steps, with one
    fused_step per iteration and no error_norm (nor fused_update for FSAL)."""
    rng = np.random.default_rng(0)
    y0 = np.array([2.0, 0.0]) + 0.1 * rng.standard_normal((32, 2))
    te = np.linspace(0.0, 6.0, 40)

    def vdp(t, y, mu):
        return torch.stack((y[:, 1], mu * (1 - y[:, 0] ** 2) * y[:, 1] - y[:, 0]), dim=-1)

    kw = dict(args=2.0, atol=1e-6, rtol=1e-6, method=method, device=cuda_device)
    for k in ops.launches:
        ops.launches[k] = 0
    fused = solve_ivp(vdp, y0, te, fused=True, **kw)
    iters = int(fused.stats["n_steps"].max())
    s, fsal = get_tableau(method).stages, get_tableau(method).fsal
    assert ops.launches == {"stage_accum": (s - 1) * iters,
                            "fused_update": 0 if fsal else iters, "error_norm": 0,
                            "interp_eval": iters, "fused_step": iters, "fused_step_poly": 0,
                            "masked_bisect_refine": 0, "fused_event_detect": 0,
                            "fused_event_commit": 0, "batched_linsolve": 0,
                            "batched_lu_factor": 0, "fused_newton_iter": 0,
                            "masked_newton_update": 0, "flash_attention_fwd": 0,
                            "flash_attention_bwd": 0}
    assert torch.equal(fused.stats["n_fused_steps"], fused.stats["n_steps"])
    unfused = solve_ivp(vdp, y0, te, **kw)
    assert torch.equal(fused.stats["n_steps"], unfused.stats["n_steps"])
    torch.testing.assert_close(fused.ys, unfused.ys, rtol=1e-9, atol=1e-9)


def test_fused_poly_solve_launches_only_fused_step_poly(cuda_device):
    y0 = np.linspace(0.5, 1.5, 64 * 8, dtype=np.float32).reshape(64, 8)
    for k in ops.launches:
        ops.launches[k] = 0
    sol = solve_ivp(polynomial_term(0.0, -1.0), y0, t_start=0.0, t_end=2.0, rtol=1e-4,
                    atol=1e-6, dense=False, fused=True, device=cuda_device)
    iters = int(sol.stats["n_steps"].max())
    assert ops.launches["fused_step_poly"] == iters == sum(ops.launches.values())
    torch.testing.assert_close(sol.ys.cpu(), torch.as_tensor(y0 * np.exp(-2.0),
                                                             dtype=torch.float32),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("poly", [False, True])
def test_fused_path_never_reaches_the_plain_version(cuda_device, poly):
    """No fallback: with the plain fused ops made to raise, a fused solve on
    the card still runs (through the kernels)."""
    term = polynomial_term(0.0, -1.0) if poly else (lambda t, y, a: -y)
    with mock.patch.object(tref, "fused_step", side_effect=AssertionError("plain")), \
            mock.patch.object(tref, "fused_step_poly", side_effect=AssertionError("plain")):
        sol = solve_ivp(term, np.ones((4, 3), np.float32), np.linspace(0.0, 1.0, 5),
                        fused=True, device=cuda_device)
    assert int(sol.status.max()) == 0
    assert bool((sol.stats["n_fused_steps"] == sol.stats["n_steps"]).all())


class TestEventKernelsOnCard:
    """The three event kernels bitwise against their plain versions on the
    same card tensors, over the cases of ``tools/event_checks.py``."""

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    @pytest.mark.parametrize("shape", [(5, 3), (13, 300), (256, 2)])
    @pytest.mark.parametrize("active", ["mixed", "all", "none"])
    def test_masked_bisect_refine(self, cuda_device, dtype, shape, active):
        b, f = shape
        args = event_checks.to_torch(event_checks.bisect_inputs(b + f, b, f, dtype, active),
                                     cuda_device)
        event_checks.assert_bitwise("masked_bisect_refine",
                                    cuda_impl.masked_bisect_refine(*args),
                                    tref.masked_bisect_refine(*args))

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    @pytest.mark.parametrize("b", [5, 256, 1024])
    @pytest.mark.parametrize("E", [1, 2, 3, 64])
    def test_fused_event_detect(self, cuda_device, dtype, b, E):
        *args, dirs = event_checks.to_torch(event_checks.detect_inputs(b + E, b, E, dtype),
                                            cuda_device)
        for directions in (dirs, (1.0,) * E, (-1.0,) * E):
            event_checks.assert_bitwise(
                "fused_event_detect", cuda_impl.fused_event_detect(*args, directions=directions),
                tref.fused_event_detect(*args, directions=directions))

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    @pytest.mark.parametrize("b", [1, 37, 1024])
    @pytest.mark.parametrize("E", [1, 2, 31, 32, 33, 63, 64])
    def test_fused_event_detect_layouts(self, cuda_device, dtype, b, E):
        """A row's segment of threads at every width (one event a thread up
        to 32, two above), every direction in one batch and each alone, NaN
        directions, NaN and +-0 condition values, mixed fired and accept."""
        *args, cycle = event_checks.to_torch(event_checks.detect_inputs(b * E, b, E, dtype),
                                             cuda_device)
        rng = np.random.default_rng(E)
        mixed = tuple(float(d) for d in rng.choice([-2.0, -1.0, -0.0, 0.0, 1.0, 3.0, np.nan], E))
        for directions in (cycle, mixed, (1.0,) * E, (-1.0,) * E, (0.0,) * E, (np.nan,) * E):
            event_checks.assert_bitwise(
                f"fused_event_detect[b={b} E={E}]",
                cuda_impl.fused_event_detect(*args, directions=directions),
                tref.fused_event_detect(*args, directions=directions))

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    @pytest.mark.parametrize("shape", [(5, 3), (13, 300), (256, 2)])
    @pytest.mark.parametrize("E", [1, 2, 3])
    @pytest.mark.parametrize("terminal", ["mixed", "all", "none"])
    def test_fused_event_commit(self, cuda_device, dtype, shape, E, terminal):
        b, f = shape
        *args, flags = event_checks.to_torch(
            event_checks.commit_inputs(b + f + E, b, f, E, dtype, terminal), cuda_device)
        ev_y = args[8].clone()
        want = tref.fused_event_commit(*args, terminal=flags)
        got = cuda_impl.fused_event_commit(*args[:8], ev_y, terminal=flags)
        assert got[2] is ev_y  # updated in place and returned
        event_checks.assert_bitwise("fused_event_commit", got, want)

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    @pytest.mark.parametrize("f", [1, 2, 3, 4, 5, 783, 784, 785])
    @pytest.mark.parametrize("aligned", [True, False])
    def test_masked_bisect_refine_widths(self, cuda_device, dtype, f, aligned):
        """Row segments at every width class (f below, at and above a
        16-byte chunk, full_width's 784 and its neighbours), b = 37 rows
        (not a multiple of a block's rows), the coefficient planes starting
        16-byte aligned (16-byte chunks, with per-row heads and tails where f
        is not a multiple of a chunk) and one entry past it (entry by
        entry)."""
        b = 37
        coeffs, *cols = event_checks.to_torch(
            event_checks.bisect_inputs(f, b, f, dtype, "mixed"), cuda_device)
        if not aligned:
            def shifted(c):
                flat = torch.empty(b * f + 1, dtype=c.dtype, device=cuda_device)
                view = flat[1:].view(b, f)
                view.copy_(c)
                return view
            coeffs = tuple(shifted(c) for c in coeffs)
        assert all(c.is_contiguous() and (c.data_ptr() % 16 == 0) == aligned for c in coeffs)
        event_checks.assert_bitwise("masked_bisect_refine",
                                    cuda_impl.masked_bisect_refine(coeffs, *cols),
                                    tref.masked_bisect_refine(coeffs, *cols))

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    @pytest.mark.parametrize("f", event_checks.COMMIT_WIDTHS)
    @pytest.mark.parametrize("E", event_checks.COMMIT_EVENTS)
    @pytest.mark.parametrize("layout", ["aligned", "y_new", "ev_y"])
    def test_fused_event_commit_widths(self, cuda_device, dtype, f, E, layout):
        """Rows below, at and above a 16-byte chunk and around full_width's
        784 (whole 16-byte words or not), E = 1, 3 and 64, b = 37 rows that
        detect no crossing, one, all at one x (a tied terminal one) and a
        random mix; the planes 16-byte aligned (16-byte chunks) or y_new or
        ev_y one entry off (entry by entry): bitwise, ev_y in place."""
        *args, flags = event_checks.to_torch(
            event_checks.commit_inputs(f + E, 37, f, E, dtype, "mixed", rows="classes"),
            cuda_device)
        want = tref.fused_event_commit(*args, terminal=flags)
        ev_y = args[8].clone() if layout != "ev_y" else event_checks.unaligned(args[8])
        if layout == "y_new":
            args[3] = event_checks.unaligned(args[3])
        got = cuda_impl.fused_event_commit(*args[:8], ev_y, terminal=flags)
        assert got[2] is ev_y
        event_checks.assert_bitwise("fused_event_commit", got, want)

    def test_event_limit_raises(self, cuda_device):
        *args, _ = event_checks.to_torch(event_checks.detect_inputs(0, 4, 65, np.float32),
                                         cuda_device)
        with pytest.raises(ValueError, match="1 to 64 events"):
            cuda_impl.fused_event_detect(*args, directions=(0.0,) * 65)


def _ball(t, y, args):
    return torch.stack((y[:, 1], torch.full_like(y[:, 1], -9.81)), dim=-1)


GROUND = Event(lambda t, y, args: y[0], terminal=True, direction=-1.0)
MARK = Event(lambda t, y, args: y[1] + 3.0, terminal=False)


@pytest.mark.parametrize("fused", [False, True])
def test_event_solve_on_card_matches_cpu_and_counts_launches(cuda_device, fused):
    """A float64 event solve on the card takes the CPU's steps and records
    the CPU's events; detect and commit launch once per iteration, the
    bisection (iters + 1) times per event that fired somewhere in a step."""
    h0 = np.linspace(1.0, 50.0, 64)
    y0 = np.stack([h0, np.zeros_like(h0)], 1)
    te = np.linspace(0.0, 2.5, 11)  # impacts at 0.45-3.19: some rows stop, some finish
    kw = dict(t_start=0.0, t_end=2.5, events=(GROUND, MARK), rtol=1e-6, atol=1e-9,
              event_bisect_iters=20, fused=fused)
    for k in ops.launches:
        ops.launches[k] = 0
    card = solve_ivp(_ball, y0, te, device=cuda_device, **kw)
    iters = int(card.stats["n_steps"].max())
    assert ops.launches["fused_event_detect"] == ops.launches["fused_event_commit"] == iters
    bis = ops.launches["masked_bisect_refine"]
    assert bis > 0 and bis % 21 == 0 and bis <= 21 * 2 * iters
    assert ops.launches["fused_step" if fused else "error_norm"] == iters
    cpu = solve_ivp(_ball, y0, te, device="cpu", **kw)
    for name in ("status", "event_mask"):
        assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name)), name
    for k in cpu.stats:
        assert torch.equal(card.stats[k].cpu(), cpu.stats[k]), k
    for name in ("ys", "event_t", "event_y"):
        torch.testing.assert_close(getattr(card, name).cpu(), getattr(cpu, name), rtol=1e-9,
                                   atol=1e-9, equal_nan=True)
    assert bool((card.status == 4).any()) and bool((card.status == 0).any())


def test_event_solve_fused_bitwise_equals_unfused_on_card(cuda_device):
    h0 = np.linspace(1.0, 50.0, 64, dtype=np.float32)
    y0 = np.stack([h0, np.zeros_like(h0)], 1)
    kw = dict(t_start=0.0, t_end=4.0, events=(GROUND, MARK), rtol=1e-6, atol=1e-9,
              device=cuda_device)
    a = solve_ivp(_ball, y0, np.linspace(0.0, 4.0, 17, dtype=np.float32), **kw)
    b = solve_ivp(_ball, y0, np.linspace(0.0, 4.0, 17, dtype=np.float32), fused=True, **kw)
    for name in ("ts", "ys", "status", "event_y", "event_mask"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert torch.equal(a.event_t.nan_to_num(-1.0), b.event_t.nan_to_num(-1.0))


def test_events_never_reach_the_plain_version(cuda_device):
    """No fallback: with the plain event ops made to raise, an event solve on
    the card still runs (through the kernels)."""
    patches = [mock.patch.object(tref, name, side_effect=AssertionError("plain"))
               for name in ("masked_bisect_refine", "fused_event_detect", "fused_event_commit")]
    for p in patches:
        p.start()
    try:
        sol = solve_ivp(_ball, np.array([[10.0, 0.0]], np.float32), None, t_start=0.0,
                        t_end=5.0, events=GROUND, device=cuda_device)
    finally:
        for p in patches:
            p.stop()
    assert int(sol.status[0]) == 4


# fused_newton_iter's widths: within one panel, at and around the 32-column
# panels, allen_cahn_full's 128, the staged elimination's limits.
PANEL_WIDTHS = (1, 2, 3, 31, 32, 33, 64, 127, 128, 129, 239, 240)


def _newton_cases(widths=NC.WIDTHS):
    for f in widths:
        for kind in NC.KINDS:
            if not ((kind == "zero_diag" and f < 2) or (kind == "ties" and f < 3)):
                yield f, kind


class TestNewtonKernelsOnCard:
    """The four chord-Newton kernels against their plain versions on the same
    card tensors, over the cases of ``tools/newton_checks.py``, and the
    card's unfused Newton iteration bitwise against its fused one."""

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    @pytest.mark.parametrize("f, kind", list(_newton_cases()))
    @pytest.mark.parametrize("active", ["mixed", "all", "none"])
    def test_against_plain(self, cuda_device, dtype, f, kind, active):
        b = 37
        M, rhs, k, fk, mask, scale = NC.to_torch(
            NC.newton_inputs(f + len(kind), b, f, dtype, kind, active), cuda_device)
        skip = NC.nan_rows(M.cpu().numpy())
        before = dict(ops.launches)
        lu, perm = cuda_impl.batched_lu_factor(M)
        NC.hold("batched_lu_factor", (lu, perm), tref.batched_lu_factor(M), dtype, matrix=M,
                skip_rows=skip)
        keep = ~torch.as_tensor(skip, device=cuda_device)
        NC.lu_reconstructs(lu[keep], perm[keep], M[keep], dtype)
        x = cuda_impl.batched_linsolve(M, rhs)
        NC.hold("batched_linsolve", (x,), (tref.batched_linsolve(M, rhs),), dtype,
                skip_rows=skip)
        it = cuda_impl.fused_newton_iter(lu, perm, k, fk, mask, scale)
        NC.hold("fused_newton_iter", it, tref.fused_newton_iter(lu, perm, k, fk, mask, scale),
                dtype, skip_rows=skip)
        if skip.any():
            assert not torch.isfinite(it[1][~keep]).any()
        up = cuda_impl.masked_newton_update(k, rhs, mask, scale)
        NC.hold("masked_newton_update", up, tref.masked_newton_update(k, rhs, mask, scale),
                dtype)
        # The unfused iteration (linsolve, then the masked update) equals the
        # fused one bitwise: the same LU, substitution and row norm.
        unfused = cuda_impl.masked_newton_update(k, cuda_impl.batched_linsolve(M, k - fk), mask,
                                                 scale)
        for a, c in zip(unfused, it):
            assert torch.equal(a.nan_to_num(7.0), c.nan_to_num(7.0))
        assert {n: ops.launches[n] - before[n] for n in (
            "batched_lu_factor", "batched_linsolve", "fused_newton_iter",
            "masked_newton_update")} == {"batched_lu_factor": 1, "batched_linsolve": 2,
                                          "fused_newton_iter": 1, "masked_newton_update": 2}

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    @pytest.mark.parametrize("f", NC.UPDATE_WIDTHS)
    @pytest.mark.parametrize("active", ["mixed", "all", "none"])
    def test_update_widths(self, cuda_device, dtype, f, active):
        """``masked_newton_update`` at the boundaries of its layout (lanes,
        128-column batches, widths not a multiple of one): held to the plain
        version, and the unfused iteration bitwise equal to
        ``fused_newton_iter`` (the same row norm)."""
        b = 37
        M, rhs, k, fk, mask, scale = NC.to_torch(
            NC.newton_inputs(f + 700, b, f, dtype, "chord", active), cuda_device)
        up = cuda_impl.masked_newton_update(k, rhs, mask, scale)
        NC.hold("masked_newton_update", up, tref.masked_newton_update(k, rhs, mask, scale),
                dtype)
        assert torch.equal(up[0][~mask], k[~mask])
        unfused = cuda_impl.masked_newton_update(k, cuda_impl.batched_linsolve(M, k - fk), mask,
                                                 scale)
        fused = cuda_impl.fused_newton_iter(*cuda_impl.batched_lu_factor(M), k, fk, mask, scale)
        for a, c in zip(unfused, fused):
            assert _same_bits(a, c)

    def test_scale_broadcasts(self, cuda_device):
        M, _, k, fk, mask, _ = NC.to_torch(NC.newton_inputs(1, 8, 5, np.float64), cuda_device)
        lu, perm = cuda_impl.batched_lu_factor(M)
        full = torch.full((8, 5), 2e-3, dtype=torch.float64, device=cuda_device)
        for s in (2e-3, full[:, :1]):
            for a, c in zip(cuda_impl.fused_newton_iter(lu, perm, k, fk, mask, s),
                            cuda_impl.fused_newton_iter(lu, perm, k, fk, mask, full)):
                assert torch.equal(a, c)
            for a, c in zip(cuda_impl.masked_newton_update(k, fk, mask, s),
                            cuda_impl.masked_newton_update(k, fk, mask, full)):
                assert torch.equal(a, c)

    def test_bad_inputs_raise(self, cuda_device):
        M, rhs, k, fk, mask, scale = NC.to_torch(NC.newton_inputs(2, 4, 3, np.float32),
                                                 cuda_device)
        lu, perm = cuda_impl.batched_lu_factor(M)
        with pytest.raises(ValueError, match="square"):
            cuda_impl.batched_lu_factor(M[:, :2].contiguous())
        with pytest.raises(ValueError, match="CUDA tensors"):
            cuda_impl.batched_linsolve(M.cpu(), rhs.cpu())
        with pytest.raises(TypeError, match="int32"):
            cuda_impl.fused_newton_iter(lu, perm.long(), k, fk, mask, scale)
        with pytest.raises(TypeError, match="float32 or float64"):
            cuda_impl.batched_lu_factor(M.half())
        with pytest.raises(ValueError, match="contiguous"):
            cuda_impl.batched_lu_factor(M.transpose(1, 2))
        with pytest.raises(ValueError, match="shapes"):
            cuda_impl.masked_newton_update(k, fk[:2], mask, scale)
        with pytest.raises(RuntimeError, match="no backward"):
            cuda_impl.batched_linsolve(M.clone().requires_grad_(True), rhs)
        # Above the device's opt-in shared memory (227 KiB on an H100: f <=
        # ~19.3k for the float64 linsolve) the wrapper raises before launching.
        f = 19500
        big = torch.empty((1, f, f), dtype=torch.float64, device=cuda_device)
        with pytest.raises(ValueError, match="shared memory"):
            cuda_impl.batched_linsolve(big, torch.ones(1, f, dtype=torch.float64,
                                                       device=cuda_device))
        del big


class TestNewtonIterBodiesOnCard:
    """``fused_newton_iter``'s bodies -- a warp per instance (f <= 32), the
    panel substitution (the LU streamed through shared memory, 32 columns
    per barrier) and the column loop -- against each other and the unfused
    iteration (``batched_linsolve`` + ``masked_newton_update``), bitwise,
    and against the plain version within ``newton_checks.hold``: at widths
    around the warp body's limit, the 32-column panels and the staged
    elimination's limits, over every ``newton_checks`` kind and active mask,
    float32 and float64."""

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    @pytest.mark.parametrize("f, kind", list(_newton_cases(PANEL_WIDTHS)))
    def test_bodies(self, cuda_device, dtype, f, kind):
        b = 37
        M, _, k, fk, mixed, scale = NC.to_torch(NC.newton_inputs(f + len(kind), b, f, dtype, kind),
                                                cuda_device)
        skip = NC.nan_rows(M.cpu().numpy())
        lu, perm = cuda_impl.batched_lu_factor(M)
        limit = cuda_impl._smem_limit("test", _build.load(), cuda_device)
        chosen = cuda_impl.newton_iter_body(f, np.dtype(dtype).itemsize, limit)
        assert chosen == ("warp" if f <= 32 else "panel")
        bodies = ("warp", "panel", "column") if f <= 32 else ("panel", "column")
        for mask in (mixed, torch.ones_like(mixed), torch.zeros_like(mixed)):
            before = dict(cuda_impl.body_launches["fused_newton_iter"])
            got = cuda_impl.fused_newton_iter(lu, perm, k, fk, mask, scale)
            assert cuda_impl.body_launches["fused_newton_iter"][chosen] == before[chosen] + 1
            unfused = cuda_impl.masked_newton_update(k, cuda_impl.batched_linsolve(M, k - fk),
                                                     mask, scale)
            for body in bodies:
                other = cuda_impl.fused_newton_iter(lu, perm, k, fk, mask, scale, body=body)
                for a, c, u in zip(got, other, unfused):
                    assert _same_bits(a, c) and _same_bits(a, u), body
            NC.hold("fused_newton_iter", got,
                    tref.fused_newton_iter(lu, perm, k, fk, mask, scale), dtype, skip_rows=skip)

    def test_entry_refuses_an_unknown_body(self, cuda_device):
        # Past the wrapper: the C entry refuses a body it does not have with
        # cudaErrorInvalidValue (1), before any launch.
        M, _, k, fk, mask, scale = NC.to_torch(NC.newton_inputs(0, 2, 4, np.float32),
                                                cuda_device)
        lu, perm = cuda_impl.batched_lu_factor(M)
        out, res = torch.empty_like(k), torch.empty(2, device=cuda_device)
        assert _build.load().rt_fused_newton_iter(
            0, 7, *(x.data_ptr() for x in (lu, perm, k, fk, mask, scale, out, res)), 2, 4,
            torch.cuda.current_stream().cuda_stream) == 1
        with pytest.raises(ValueError, match="unknown body"):
            cuda_impl.fused_newton_iter(lu, perm, k, fk, mask, scale, body="blocked")
        # ... and the warp body above 32 columns
        M, _, k, fk, mask, scale = NC.to_torch(NC.newton_inputs(0, 2, 33, np.float32),
                                                cuda_device)
        lu, perm = cuda_impl.batched_lu_factor(M)
        out = torch.empty_like(k)
        assert _build.load().rt_fused_newton_iter(
            0, 2, *(x.data_ptr() for x in (lu, perm, k, fk, mask, scale, out, res)), 2, 33,
            torch.cuda.current_stream().cuda_stream) == 1


def _stiff_vdp(t, y, mu):
    return torch.stack((y[:, 1], mu * (1 - y[:, 0] ** 2) * y[:, 1] - y[:, 0]), dim=-1)


@pytest.mark.parametrize("fused", [False, True])
def test_stiff_solve_on_card_matches_cpu_and_counts_launches(cuda_device, fused):
    """A float64 kvaerno5 solve over four decades of stiffness on the card
    takes the CPU's steps, Newton iterations and Jacobian evaluations; each
    batched Newton iteration launches one batched_linsolve and one
    masked_newton_update (unfused) or one fused_newton_iter (fused), and the
    fused path factors once per step attempt."""
    mu = np.repeat(10.0 ** np.linspace(0.0, 3.0, 8), 4)
    y0 = np.tile([[2.0, 0.0]], (32, 1))
    te = np.linspace(0.0, 1.0, 9)
    kw = dict(args=mu, method="kvaerno5", rtol=1e-5, atol=1e-7, fused=fused)
    for name in ops.launches:
        ops.launches[name] = 0
    card = solve_ivp(_stiff_vdp, y0, te, device=cuda_device, **kw)
    iters = int(card.stats["n_steps"].max())
    newton = int(card.stats["n_f_evals"][0]) - 2  # kvaerno5: only Newton evaluations
    want = dict.fromkeys(ops.launches, 0)
    want.update(stage_accum=6 * iters, interp_eval=iters)
    if fused:
        want.update(batched_lu_factor=iters, fused_newton_iter=newton, fused_step=iters)
    else:
        want.update(batched_linsolve=newton, masked_newton_update=newton, fused_update=iters,
                    error_norm=iters)
    assert ops.launches == want
    cpu = solve_ivp(_stiff_vdp, y0, te, device="cpu", **kw)
    for name in cpu.stats:
        assert torch.equal(card.stats[name].cpu(), cpu.stats[name]), name
    assert torch.equal(card.status.cpu(), cpu.status) and bool((cpu.status == 0).all())
    torch.testing.assert_close(card.ys.cpu(), cpu.ys, rtol=1e-9, atol=1e-9)


def test_stiff_fused_solve_bitwise_equals_unfused_on_card(cuda_device):
    mu = (10.0 ** np.linspace(0.0, 3.0, 64)).astype(np.float32)
    y0 = np.tile(np.array([[2.0, 0.0]], np.float32), (64, 1))
    kw = dict(t_start=0.0, t_end=2.0, args=mu, method=DiagonallyImplicitRK("kvaerno5"),
              rtol=1e-4, atol=1e-6, device=cuda_device)
    a = solve_ivp(_stiff_vdp, y0, None, **kw)
    c = solve_ivp(_stiff_vdp, y0, None, fused=True, **kw)
    for name in ("ts", "ys", "status"):
        assert torch.equal(getattr(a, name), getattr(c, name)), name
    for name in a.stats:
        assert torch.equal(a.stats[name], c.stats[name]), name
    assert bool((a.status == 0).all())


def test_stiff_path_never_reaches_the_plain_version(cuda_device):
    """No fallback: with the plain Newton ops made to raise, stiff solves on
    the card still run (through the kernels), unfused and fused."""
    patches = [mock.patch.object(tref, name, side_effect=AssertionError("plain"))
               for name in ("batched_linsolve", "batched_lu_factor", "fused_newton_iter",
                            "masked_newton_update")]
    for p in patches:
        p.start()
    try:
        for fused in (False, True):
            sol = solve_ivp(_stiff_vdp, np.array([[2.0, 0.0]], np.float32), None, t_start=0.0,
                            t_end=1.0, args=100.0, method="kvaerno5", fused=fused,
                            device=cuda_device)
            assert int(sol.status[0]) == 0
    finally:
        for p in patches:
            p.stop()


@pytest.mark.parametrize("f", [4096, 8192])
def test_wide_newton_kernels_against_plain(cuda_device, f):
    """The substitution kernels above their old 48 KiB limit (ROADMAP C-8),
    float64, b = 4: ``batched_lu_factor`` (column by column over the card
    from 1024 columns on) with the plain permutation, ``batched_linsolve``
    and ``fused_newton_iter`` held to their plain versions at 1e-12, and the
    unfused iteration bitwise equal to the fused one."""
    M, rhs, k, fk, mask, scale = NC.wide_inputs(f, 4, f, np.float64, cuda_device)
    lu_p, perm_p = tref.batched_lu_factor(M)
    lu, perm = cuda_impl.batched_lu_factor(M)
    NC.hold("batched_lu_factor", (lu, perm), (lu_p, perm_p), np.float64, matrix=M)
    NC.hold("batched_linsolve", (cuda_impl.batched_linsolve(M, rhs),),
            (tref.batched_linsolve(M, rhs),), np.float64)
    it = cuda_impl.fused_newton_iter(lu_p, perm_p, k, fk, mask, scale)
    NC.hold("fused_newton_iter", it, tref.fused_newton_iter(lu_p, perm_p, k, fk, mask, scale),
            np.float64)
    unfused = cuda_impl.masked_newton_update(k, cuda_impl.batched_linsolve(M, k - fk), mask,
                                             scale)
    fused = cuda_impl.fused_newton_iter(lu, perm, k, fk, mask, scale)
    for a, c in zip(unfused, fused):
        assert torch.equal(a, c)


def _same_bits(a, c):
    return torch.equal(a.nan_to_num(7.0), c.nan_to_num(7.0))


class TestStagedEliminationOnCard:
    """The elimination staged in shared memory (``lu_path`` "staged", the
    main path's at f <= 239 / 169) against the device-memory one ("global"):
    equal factors, permutation and solutions bit for bit, both held to the
    plain versions; the unfused Newton iteration on the staged linsolve
    bitwise equal to the fused one on the staged LU.  Widths: the stiff
    workloads' 2, 3 and 128, others, the widest staged f of each op and
    dtype, and the narrowest global one (where "staged" is refused)."""

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    @pytest.mark.parametrize("f", [2, 3, 17, 64, 128, "max_staged", "min_global"])
    @pytest.mark.parametrize("kind", NC.KINDS)
    def test_staged_against_global(self, cuda_device, dtype, f, kind):
        itemsize = np.dtype(dtype).itemsize
        limit = cuda_impl._smem_limit("test", _build.load(), cuda_device)
        widths = {}
        for with_rhs in (False, True):
            f_max = max(n for n in range(1, 1024)
                        if cuda_impl.lu_path(n, itemsize, limit, with_rhs) == "staged")
            widths[with_rhs] = {"max_staged": f_max, "min_global": f_max + 1}.get(f, f)
        for with_rhs, width in widths.items():
            if (kind == "zero_diag" and width < 2) or (kind == "ties" and width < 3):
                continue
            M, rhs, k, fk, mask, scale = NC.to_torch(
                NC.newton_inputs(width + len(kind), 29, width, dtype, kind), cuda_device)
            skip = NC.nan_rows(M.cpu().numpy())
            path = cuda_impl.lu_path(width, itemsize, limit, with_rhs)
            assert path == ("global" if f == "min_global" else "staged")
            name = "batched_linsolve" if with_rhs else "batched_lu_factor"
            run = ((lambda p: cuda_impl.batched_linsolve(M, rhs, path=p)) if with_rhs
                   else (lambda p: cuda_impl.batched_lu_factor(M, path=p)))
            before = dict(cuda_impl.body_launches[name])
            got = run(None)  # the selection's path
            assert cuda_impl.body_launches[name][path] == before[path] + 1
            if with_rhs:
                NC.hold(name, (got,), (tref.batched_linsolve(M, rhs),), dtype, skip_rows=skip)
            else:
                NC.hold(name, got, tref.batched_lu_factor(M), dtype, matrix=M, skip_rows=skip)
            if path == "global":
                with pytest.raises(ValueError, match="staged path takes"):
                    run("staged")
                continue
            glob = run("global")
            for a, c in zip(got if isinstance(got, tuple) else (got,),
                            glob if isinstance(glob, tuple) else (glob,)):
                assert _same_bits(a, c)
            if with_rhs:
                # the unfused iteration on the staged linsolve equals the
                # fused one on the staged LU, bit for bit
                lu, perm = cuda_impl.batched_lu_factor(M, path="staged")
                unfused = cuda_impl.masked_newton_update(
                    k, cuda_impl.batched_linsolve(M, k - fk, path="staged"), mask, scale)
                fused = cuda_impl.fused_newton_iter(lu, perm, k, fk, mask, scale)
                for a, c in zip(unfused, fused):
                    assert _same_bits(a, c)

    def test_entry_refuses_a_path_that_does_not_fit(self, cuda_device):
        # Called past the wrapper: the C entry itself refuses the staged path
        # above the shared-memory limit, and an unknown path, with
        # cudaErrorInvalidValue (1), before any launch.
        lib = _build.load()
        f = 400
        A = torch.eye(f, dtype=torch.float64, device=cuda_device)[None].contiguous()
        lu = torch.empty_like(A)
        perm = torch.empty(1, f, dtype=torch.int32, device=cuda_device)
        stream = torch.cuda.current_stream().cuda_stream
        for path in (cuda_impl.LU_PATHS["staged"], 7):
            assert lib.rt_batched_lu_factor(1, path, A.data_ptr(), lu.data_ptr(),
                                            perm.data_ptr(), 1, f, stream) == 1
        with pytest.raises(ValueError, match="staged path takes"):
            cuda_impl.batched_lu_factor(A, path="staged")


# b, sq, sk, H, KV, hd, causal, q_offset: tests/test_flash_kernel.py's CASES
# (sq == sk), ragged lengths, chunked-prefill continuations, MQA, hd = 80
# (stablelm-3b) and the widest head the kernel takes.
FLASH_CASES = [
    (1, 32, 32, 2, 2, 8, True, 0), (2, 64, 64, 4, 2, 16, True, 0),
    (1, 64, 64, 4, 4, 16, False, 0), (2, 128, 128, 8, 2, 32, True, 0),
    (1, 128, 128, 4, 1, 16, True, 0),
    (2, 37, 37, 4, 2, 16, True, 0), (2, 37, 45, 4, 2, 16, True, 8),
    (1, 13, 45, 4, 2, 16, True, 32), (1, 37, 45, 4, 4, 16, False, 0),
    (1, 100, 300, 4, 2, 64, True, 200), (1, 70, 130, 4, 2, 64, False, 0),
    (2, 129, 129, 32, 32, 80, True, 0), (1, 77, 77, 4, 4, 80, False, 0),
    (1, 65, 65, 8, 2, 128, True, 0), (1, 64, 64, 2, 1, 256, True, 0),
    (1, 50, 90, 2, 2, 192, False, 0),
]


class TestFlashKernelOnCard:
    """``flash_attention_fwd`` against its plain version on the same card
    tensors: float32 at 2e-5, bfloat16 at 3e-2 (the reference's own
    kernel-vs-oracle tolerances)."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("b,sq,sk,H,KV,hd,causal,q_offset", FLASH_CASES)
    def test_against_plain(self, cuda_device, dtype, b, sq, sk, H, KV, hd, causal, q_offset):
        g = _gen(sq * sk + hd)
        q, k, v = (torch.randn(shape, generator=g).to(cuda_device, dtype)
                   for shape in ((b, sq, H, hd), (b, sk, KV, hd), (b, sk, KV, hd)))
        before = ops.launches["flash_attention_fwd"]
        body = cuda_impl.flash_body(hd, dtype)
        before_body = cuda_impl.body_launches["flash_attention_fwd"][body]
        got = ops.flash_attention_fwd(q, k, v, causal=causal, q_offset=q_offset)
        assert ops.launches["flash_attention_fwd"] == before + 1
        assert cuda_impl.body_launches["flash_attention_fwd"][body] == before_body + 1
        want = tref.flash_attention_fwd(q, k, v, causal=causal, q_offset=q_offset, q_chunk=32,
                                        kv_chunk=64)
        assert got.dtype == dtype and got.shape == (b, sq, H, hd)
        tol = 2e-5 if dtype == torch.float32 else 3e-2
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)

    @pytest.mark.parametrize("b,sq,sk,H,KV,hd,causal,q_offset",
                             [c for c in FLASH_CASES if c[5] <= 128])
    def test_ffma_body_in_bf16(self, cuda_device, b, sq, sk, H, KV, hd, causal, q_offset):
        """The FFMA body takes the wgmma body's shapes too (it is what bf16
        heads above 128 run): held to the plain version at 3e-2."""
        g = _gen(sq * sk + hd + 1)
        q, k, v = (torch.randn(shape, generator=g).to(cuda_device, torch.bfloat16)
                   for shape in ((b, sq, H, hd), (b, sk, KV, hd), (b, sk, KV, hd)))
        got = cuda_impl.flash_attention_fwd(q, k, v, causal=causal, q_offset=q_offset,
                                            body="ffma")
        want = tref.flash_attention_fwd(q, k, v, causal=causal, q_offset=q_offset, q_chunk=32,
                                        kv_chunk=64)
        torch.testing.assert_close(got.float(), want.float(), rtol=3e-2, atol=3e-2)

    def test_serve_layer_against_plain(self, cuda_device):
        """qwen2.5-14b's layer as the full-width serve's prefill gives it (b =
        4, s = 2048, 40 query / 8 KV heads, hd = 128, bf16, causal): the wgmma
        body, within 3e-2 of the plain version."""
        g = torch.Generator(device=cuda_device).manual_seed(2048)
        q = torch.randn(4, 2048, 40, 128, generator=g, device=cuda_device).bfloat16()
        k, v = (torch.randn(4, 2048, 8, 128, generator=g, device=cuda_device).bfloat16()
                for _ in range(2))
        before = cuda_impl.body_launches["flash_attention_fwd"]["wgmma"]
        got = ops.flash_attention_fwd(q, k, v)
        assert cuda_impl.body_launches["flash_attention_fwd"]["wgmma"] == before + 1
        want = tref.flash_attention_fwd(q, k, v, q_chunk=512, kv_chunk=1024)
        torch.testing.assert_close(got.float(), want.float(), rtol=3e-2, atol=3e-2)

    def test_entry_refuses_wgmma_outside_its_shapes(self, cuda_device):
        # Past the wrapper, the C entry refuses the wgmma body for float32 and
        # for hd > 128 with cudaErrorInvalidValue (1); the wrapper raises first.
        lib = _build.load()
        stream = torch.cuda.current_stream().cuda_stream
        for dtype, hd in ((torch.float32, 64), (torch.bfloat16, 136)):
            q = torch.zeros(1, 8, 2, hd, dtype=dtype, device=cuda_device)
            out = torch.empty_like(q)
            code = 0 if dtype == torch.float32 else 1
            assert lib.rt_flash_attention_fwd(code, cuda_impl.FLASH_BODIES["wgmma"], q.data_ptr(),
                                              q.data_ptr(), q.data_ptr(), out.data_ptr(), None, 1,
                                              8, 8, 2, 2, hd, 1, 0, stream) == 1
            with pytest.raises(ValueError, match="wgmma body"):
                cuda_impl.flash_attention_fwd(q, q, q, body="wgmma")

    def test_matches_the_oracle(self, cuda_device):
        g = _gen(11)
        q, k, v = (torch.randn(shape, generator=g).to(cuda_device)
                   for shape in ((2, 200, 8, 64), (2, 200, 2, 64), (2, 200, 2, 64)))
        for causal in (True, False):
            torch.testing.assert_close(cuda_impl.flash_attention_fwd(q, k, v, causal=causal),
                                       tref.flash_attention_ref(q, k, v, causal=causal),
                                       rtol=2e-5, atol=2e-5)

    def test_never_reaches_the_plain_version(self, cuda_device):
        q = torch.randn(1, 37, 4, 16, device=cuda_device)
        k = torch.randn(1, 45, 2, 16, device=cuda_device)
        with mock.patch.object(tref, "flash_attention_fwd", side_effect=AssertionError("plain")):
            out = ops.flash_attention_fwd(q, k, k, q_offset=8, q_chunk=16, kv_chunk=16)
        assert out.shape == q.shape

    def test_bad_inputs_raise(self, cuda_device):
        q = torch.randn(1, 8, 4, 16, device=cuda_device)
        k = torch.randn(1, 8, 3, 16, device=cuda_device)
        with pytest.raises(ValueError, match="KV heads"):
            cuda_impl.flash_attention_fwd(q, k, k)
        with pytest.raises(ValueError, match="head dim"):
            cuda_impl.flash_attention_fwd(q[..., :12].contiguous(), q[..., :12].contiguous(),
                                          q[..., :12].contiguous())
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            cuda_impl.flash_attention_fwd(q.half(), q.half(), q.half())
        with pytest.raises(TypeError, match="expected"):
            cuda_impl.flash_attention_fwd(q, q.bfloat16(), q)
        with pytest.raises(ValueError, match="contiguous"):
            cuda_impl.flash_attention_fwd(q.transpose(1, 2), q, q)
        with pytest.raises(ValueError, match="q_offset"):
            cuda_impl.flash_attention_fwd(q, q, q, q_offset=-1)
        with pytest.raises(RuntimeError, match="no backward"):
            cuda_impl.flash_attention_fwd(q.clone().requires_grad_(True), q, q)


def test_lm_prefill_on_card_matches_cpu(cuda_device):
    """Reduced qwen2.5-14b in float32, the same weights on the card and the
    CPU: one flash kernel launch per layer per prefill and none per decode
    step; prefill and decode logits within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM

    cfg = get_config("qwen2.5-14b", reduced=True)
    cpu = LM(cfg, device="cpu", seed=0)
    card = LM(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    tok = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (2, 37)))
    before = ops.launches["flash_attention_fwd"]
    lg, cache = card.prefill({"tokens": tok.to(cuda_device)})
    assert ops.launches["flash_attention_fwd"] == before + cfg.n_layers
    lg_cpu, cache_cpu = cpu.prefill({"tokens": tok})
    torch.testing.assert_close(lg.cpu(), lg_cpu, rtol=1e-4, atol=1e-4)
    cache, cache_cpu = card.pad_cache(cache, 41), cpu.pad_cache(cache_cpu, 41)
    for i in range(4):
        pos = torch.full((2,), 37 + i)
        lg, cache = card.decode_step(tok[:, i].to(cuda_device), pos.to(cuda_device), cache)
        lg_cpu, cache_cpu = cpu.decode_step(tok[:, i], pos, cache_cpu)
        torch.testing.assert_close(lg.cpu(), lg_cpu, rtol=1e-4, atol=1e-4)
    assert ops.launches["flash_attention_fwd"] == before + cfg.n_layers


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "kimi-k2-1t-a32b", "jamba-v0.1-52b",
                                  "xlstm-350m", "whisper-large-v3", "llava-next-34b"])
def test_lm_kinds_on_card_match_cpu(cuda_device, arch):
    """The reduced configs beyond the dense decoder in float32, the same
    weights and frontend embeddings on the card and the CPU: one flash
    launch per attention layer per prefill (the encoder's and the cross
    attention's too) and none per decode step; prefill and decode logits and
    the caches after four decode steps within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.models.frontends import fake_audio_embeds, fake_img_embeds

    cfg = get_config(arch, reduced=True)
    cpu = LM(cfg, device="cpu", seed=0)
    card = LM(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    emb = {}
    if cfg.n_img_tokens:
        emb["img_embeds"] = fake_img_embeds(cfg, 2, device="cpu")
    if cfg.enc_dec:
        emb["audio_embeds"] = fake_audio_embeds(cfg, 2, 37, device="cpu")
    flash = sum(k.startswith("attn") for k in cfg.pattern) * cfg.n_periods
    flash += 2 * cfg.n_periods if cfg.enc_dec else 0
    tok = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (2, 41)))
    before = ops.launches["flash_attention_fwd"]
    lg, cache = card.prefill({"tokens": tok[:, :37].to(cuda_device),
                              **{k: v.to(cuda_device) for k, v in emb.items()}})
    assert ops.launches["flash_attention_fwd"] == before + flash
    lg_cpu, cache_cpu = cpu.prefill({"tokens": tok[:, :37], **emb})
    torch.testing.assert_close(lg.cpu(), lg_cpu, rtol=1e-4, atol=1e-4)
    cache, cache_cpu = card.pad_cache(cache, 41), cpu.pad_cache(cache_cpu, 41)
    for i in range(37, 41):
        pos = torch.full((2,), i)
        lg, cache = card.decode_step(tok[:, i].to(cuda_device), pos.to(cuda_device), cache)
        lg_cpu, cache_cpu = cpu.decode_step(tok[:, i], pos, cache_cpu)
        torch.testing.assert_close(lg.cpu(), lg_cpu, rtol=1e-4, atol=1e-4)
    for key, layer in cache_cpu.items():
        for name, t in layer.items():
            torch.testing.assert_close(cache[key][name].cpu(), t, rtol=1e-4, atol=1e-4)
    assert ops.launches["flash_attention_fwd"] == before + flash


class TestGradientsOnCard:
    """The thirteen Functions of ``kernels/autograd.py`` on the card against
    ``torch.autograd.grad`` of the plain ops on the card
    (``tools/grad_checks.py``'s cases and rule), ``ScanAdjoint`` and
    ``BacksolveAdjoint`` gradients on the card against the CPU's in float64
    (the explicit path, ``fused=True``, ``events=`` and the stiff path), and
    no fallback to the plain ops."""

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    @pytest.mark.parametrize("b,f,n", [(37, 2, 9), (37, 784, 9), (5, 33, 200)])
    def test_backwards_against_plain(self, cuda_device, dtype, b, f, n):
        tdtype = torch.float32 if dtype == np.float32 else torch.float64
        before = dict(ops.launches)
        for case in grad_checks.cases(b, f, n, dtype, seed=f):
            want = grad_checks.case_grads(case, grad_checks.plain(case["op"]), cuda_device)
            got = grad_checks.case_grads(case, grad_checks.function(case["op"]), cuda_device)
            grad_checks.hold(f"{case['op']}[{case['label']}]", got, want, tdtype)
        assert all(ops.launches[k] > before[k] for k in grad_checks.EXPLICIT)

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    @pytest.mark.parametrize("f", [1, 2, 3, 5, 33])
    def test_path_backwards_against_plain(self, cuda_device, dtype, f):
        """The nine backwards of ``fused=True``, ``events=`` and the stiff
        path against ``grad_checks.card_plain`` by ``grad_checks.hold_on_card``
        (the event ops entry by entry; the others row by row in float64 and
        against the float64 plain op in float32); the LU cases pivot as LAPACK does (the gradients would part at
        another permutation)."""
        tdtype = torch.float32 if dtype == np.float32 else torch.float64
        nine = grad_checks.FUSED + grad_checks.EVENTS + grad_checks.STIFF
        before = dict(ops.launches)
        for case in grad_checks.cases(13, f, 9, dtype, seed=f, ops=nine):
            op = case["op"]
            if op == "batched_lu_factor":
                A = torch.as_tensor(case["args"]["A"], device=cuda_device)
                assert torch.equal(cuda_impl.batched_lu_factor(A)[1],
                                   tref.batched_lu_factor(A)[1]), case["label"]
            want = grad_checks.case_grads(case, grad_checks.card_plain(op), cuda_device)
            got = grad_checks.case_grads(case, grad_checks.function(op), cuda_device)
            grad_checks.hold_on_card(f"{op}[{case['label']}]", case, got, want, tdtype,
                                     cuda_device)
        assert all(ops.launches[k] > before[k] for k in nine)

    @pytest.mark.parametrize("driver,mode,every", [("scan", None, 0), ("scan", None, 16),
                                                   ("backsolve", "joint", 0),
                                                   ("backsolve", "per_instance", 0)])
    def test_float64_gradients_match_cpu(self, cuda_device, driver, mode, every):
        kw = dict(driver=driver, mode=mode, checkpoint_every=every)
        for k in ops.launches:
            ops.launches[k] = 0
        card = grad_checks.train_grads(cuda_device, **kw)
        # The backsolve tracks the final state only: no dense output.
        used = grad_checks.EXPLICIT if driver == "scan" else grad_checks.EXPLICIT[:3]
        assert all(ops.launches[k] > 0 for k in used)
        grad_checks.hold_card_to_cpu(driver, card, grad_checks.train_grads("cpu", **kw))

    @pytest.mark.parametrize("variant", ["fused", "events", "kvaerno5", "kvaerno5_factor_once"])
    def test_paths_without_a_backward_refuse(self, cuda_device, variant):
        """The paths that had no backward on the card now differentiate
        there: the reduced float64 twins (``full_width_train`` with
        ``fused=True`` or its events, ``allen_cahn_full`` unfused and
        factor-once) on the card against the CPU -- equal step, event and
        Newton counts, gradients within 1e-9 -- every kernel of the path
        launched through its Function (a raw wrapper refuses grad)."""
        kernels = {"fused": ("fused_step",),
                   "events": ("masked_bisect_refine", "fused_event_detect",
                              "fused_event_commit"),
                   "kvaerno5": ("batched_linsolve", "masked_newton_update"),
                   "kvaerno5_factor_once": ("batched_lu_factor", "fused_newton_iter",
                                            "fused_step")}[variant]
        if variant in ("fused", "events"):
            run = lambda device: grad_checks.train_grads(device, fused=variant == "fused",
                                                         events=variant == "events")
        else:
            run = lambda device: grad_checks.stiff_grads(
                device, fused=variant == "kvaerno5_factor_once")
        for k in ops.launches:
            ops.launches[k] = 0
        card = run(cuda_device)
        assert all(ops.launches[k] > 0 for k in kernels), dict(ops.launches)
        grad_checks.hold_card_to_cpu(variant, card, run("cpu"))
        v = torch.ones(2, 2, device=cuda_device, requires_grad=True)
        fired = torch.zeros(2, 2, dtype=torch.bool, device=cuda_device)
        with pytest.raises(RuntimeError, match="no backward"):
            cuda_impl.fused_event_detect(v, v.detach(), fired, fired[:, 0].contiguous(),
                                         directions=(0.0, 1.0))

    def test_no_fallback_to_the_plain_ops(self, cuda_device):
        """With every plain op of the four made to raise, a card gradient
        still succeeds: the forward is the kernels', the backward the
        Functions' own."""
        def boom(*a, **k):
            raise AssertionError("the plain op ran on the card")

        with mock.patch.multiple(tref, stage_accum=boom, fused_update=boom, error_norm=boom,
                                 interp_eval=boom, interp_eval_window=boom):
            _, grads, _ = grad_checks.train_grads(cuda_device, rows=4)
        assert all(np.isfinite(g).all() for g in grads)
