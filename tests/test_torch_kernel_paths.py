"""The choice of body or path of the kernels that have more than one, on
the CPU: ``cuda_impl.flash_body`` and ``cuda_impl.flash_bwd_body`` (the
attention's and its backward's wgmma or FFMA body), ``cuda_impl.lu_path``
(the elimination staged in shared memory, in device memory, or column by
column over the card), ``cuda_impl.newton_iter_body`` (``fused_newton_iter``'s
panel or column substitution) and ``cuda_impl.fused_step_poly_body`` and
``cuda_impl.fused_step_body`` (a warp or a block per row),
``cuda_impl.error_norm_body`` (a warp or a block per row, or the wide body's
two passes) and ``cuda_impl.interp_eval_body`` (a thread per cell or a block
per row), on every
boundary, and the wrappers' own checks, which raise ``ValueError`` wherever
the C entries would refuse a body or path -- before any launch, so a refusal
never reaches the card.  Also ``cuda_impl.direction_masks``, the host's
encoding of ``fused_event_detect``'s directions.

The card tests (``tests/test_torch_kernels_card.py``) hold each body and
path to the plain version, the staged elimination bitwise to the
device-memory one, the panel substitution bitwise to the column one and the
row bodies of ``fused_step_poly`` and ``fused_step`` bitwise to their warp
bodies.
"""

import math
import pathlib
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import cuda_impl  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.tools import event_checks  # noqa: E402

# The device's opt-in shared memory per block less the linalg kernels'
# static shared memory, as rt_linalg_max_smem() reports it on an H100
# (NVIDIA H100 80GB HBM3), two smaller limits (an A100's 163 KiB and the
# 48 KiB default) and one so large that the staged path's column bound
# (LU_STAGED_MAX_F, a lane's columns in registers) binds first.
H100_SMEM = 232048
LIMITS = (H100_SMEM, 163 * 1024 - 400, 48 * 1024, 2**30)
# The widest staged matrix at H100_SMEM: (itemsize, with_rhs) -> f.
H100_STAGED_MAX = {(4, False): 239, (4, True): 238, (8, False): 169, (8, True): 168}

HEAD_DIMS = list(range(8, 257, 8))


class TestFlashBody:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("hd", HEAD_DIMS)
    def test_selection_and_checks(self, hd, dtype):
        body = cuda_impl.flash_body(hd, dtype)
        want = "wgmma" if dtype == torch.bfloat16 and hd <= 128 else "ffma"
        assert body == want
        cuda_impl.check_flash_body(body, hd, dtype)  # the chosen body is taken
        cuda_impl.check_flash_body("ffma", hd, dtype)  # FFMA takes every shape
        if want == "ffma":
            with pytest.raises(ValueError, match="wgmma body takes bfloat16 with hd <= 128"):
                cuda_impl.check_flash_body("wgmma", hd, dtype)
        else:
            cuda_impl.check_flash_body("wgmma", hd, dtype)

    def test_unknown_body(self):
        with pytest.raises(ValueError, match="unknown body"):
            cuda_impl.check_flash_body("mma", 64, torch.bfloat16)

    @pytest.mark.parametrize("body, hd, dtype", [
        ("wgmma", 136, torch.bfloat16), ("wgmma", 64, torch.float32), ("mma", 64, torch.bfloat16),
    ])
    def test_wrapper_refuses_before_the_launch(self, body, hd, dtype):
        # CPU tensors: the body check comes before the device check, so the
        # refusal shows here as it would on the card.
        q = torch.zeros(1, 8, 2, hd, dtype=dtype)
        k = torch.zeros(1, 8, 1, hd, dtype=dtype)
        with pytest.raises(ValueError, match="wgmma|unknown body"):
            cuda_impl.flash_attention_fwd(q, k, k, body=body)

    def test_wrapper_takes_a_valid_body_to_the_device_check(self):
        q = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
        k = torch.zeros(1, 8, 1, 64, dtype=torch.bfloat16)
        for body in ("wgmma", "ffma", None):
            with pytest.raises(ValueError, match="CUDA tensors"):
                cuda_impl.flash_attention_fwd(q, k, k, body=body)


class TestFlashBwdBody:
    """The attention backward's body: wgmma for bfloat16 with hd <= 128, FFMA
    elsewhere and for every shape, as the forward's."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("hd", HEAD_DIMS)
    def test_selection_and_checks(self, hd, dtype):
        body = cuda_impl.flash_bwd_body(hd, dtype)
        want = "wgmma" if dtype == torch.bfloat16 and hd <= 128 else "ffma"
        assert body == want
        cuda_impl.check_flash_bwd_body(body, hd, dtype)
        cuda_impl.check_flash_bwd_body("ffma", hd, dtype)
        if want == "ffma":
            with pytest.raises(ValueError, match="wgmma body takes bfloat16 with hd <= 128"):
                cuda_impl.check_flash_bwd_body("wgmma", hd, dtype)
        else:
            cuda_impl.check_flash_bwd_body("wgmma", hd, dtype)

    def test_unknown_body(self):
        with pytest.raises(ValueError, match="unknown body"):
            cuda_impl.check_flash_bwd_body("mma", 64, torch.bfloat16)

    def test_bodies_are_numbered_as_the_entry_takes_them(self):
        assert cuda_impl.FLASH_BWD_BODIES == {"wgmma": 0, "ffma": 1}
        assert (cuda_impl.body_launches["flash_attention_bwd"].keys()
                == cuda_impl.FLASH_BWD_BODIES.keys())

    @staticmethod
    def _args(hd, dtype, b=1, s=8, H=2, KV=1):
        q = torch.zeros(b, s, H, hd, dtype=dtype)
        k = torch.zeros(b, s, KV, hd, dtype=dtype)
        return q, k, k, q, torch.zeros(b, H, s), q

    @pytest.mark.parametrize("body, hd, dtype", [
        ("wgmma", 64, torch.float32), ("mma", 64, torch.bfloat16), ("wgmma", 80, torch.float32),
    ])
    def test_wrapper_refuses_before_the_launch(self, body, hd, dtype):
        before = dict(cuda_impl.launches)
        with pytest.raises(ValueError, match="wgmma|unknown body"):
            cuda_impl.flash_attention_bwd(*self._args(hd, dtype), body=body)
        assert cuda_impl.launches == before

    def test_wrapper_takes_a_valid_body_to_the_device_check(self):
        for body in ("wgmma", "ffma", None):
            with pytest.raises(ValueError, match="CUDA tensors"):
                cuda_impl.flash_attention_bwd(*self._args(80, torch.bfloat16), body=body)

    def test_no_atomics(self):
        """Both bodies sum in a fixed order (two launches, no atomics), so
        every call gives the same bits."""
        src = (pathlib.Path(cuda_impl.__file__).parent / "csrc" / "flash_attn_bwd.cu").read_text()
        code = "\n".join(line.split("//")[0] for line in src.splitlines())
        assert "atomic" not in code and "red." not in code


def _staged_max(itemsize, with_rhs, limit):
    """The widest staged f at ``limit``, by walking up from f = 1."""
    f = 0
    while (f < cuda_impl.LU_STAGED_MAX_F
           and cuda_impl.staged_smem_bytes(f + 1, itemsize, with_rhs) <= limit):
        f += 1
    return f


class TestLuPath:
    def test_staged_bytes_layout(self):
        # the matrix at row stride f + 1, the multipliers, (the rhs,) the
        # int32 permutation
        assert cuda_impl.staged_smem_bytes(128, 4) == 4 * (128 * 129 + 128) + 4 * 128
        assert cuda_impl.staged_smem_bytes(128, 8, True) == 8 * (128 * 129 + 256) + 4 * 128
        assert cuda_impl.staged_smem_bytes(128, 4) == 67072  # 65.5 KiB: 3 blocks per SM

    @pytest.mark.parametrize("with_rhs", [False, True])
    @pytest.mark.parametrize("itemsize", [4, 8])
    def test_h100_staged_limit(self, itemsize, with_rhs):
        f_max = H100_STAGED_MAX[(itemsize, with_rhs)]
        assert _staged_max(itemsize, with_rhs, H100_SMEM) == f_max
        assert cuda_impl.lu_path(128, itemsize, H100_SMEM, with_rhs) == "staged"  # allen_cahn

    @pytest.mark.parametrize("limit", LIMITS)
    @pytest.mark.parametrize("with_rhs", [False, True])
    @pytest.mark.parametrize("itemsize", [4, 8])
    def test_boundaries(self, itemsize, with_rhs, limit):
        f_max = _staged_max(itemsize, with_rhs, limit)
        assert 1 <= f_max < cuda_impl.LU_WIDE_F
        for f in (1, 2, 3, f_max):
            assert cuda_impl.lu_path(f, itemsize, limit, with_rhs) == "staged"
        for f in (f_max + 1, cuda_impl.LU_WIDE_F - 1):
            assert cuda_impl.lu_path(f, itemsize, limit, with_rhs) == "global"
        for f in (cuda_impl.LU_WIDE_F, 4096, 8192):
            assert cuda_impl.lu_path(f, itemsize, limit, with_rhs) == "wide"

    @pytest.mark.parametrize("limit", LIMITS)
    @pytest.mark.parametrize("with_rhs", [False, True])
    @pytest.mark.parametrize("itemsize", [4, 8])
    def test_checks_match_the_selection(self, itemsize, with_rhs, limit):
        f_max = _staged_max(itemsize, with_rhs, limit)
        for f in (1, f_max, f_max + 1, cuda_impl.LU_WIDE_F, 8192):
            chosen = cuda_impl.lu_path(f, itemsize, limit, with_rhs)
            cuda_impl.check_lu_path("x", chosen, f, itemsize, limit, with_rhs)
            for path in ("global", "wide"):  # take every width
                cuda_impl.check_lu_path("x", path, f, itemsize, limit, with_rhs)
            if f <= f_max:
                cuda_impl.check_lu_path("x", "staged", f, itemsize, limit, with_rhs)
            else:
                with pytest.raises(ValueError, match="staged path takes"):
                    cuda_impl.check_lu_path("x", "staged", f, itemsize, limit, with_rhs)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("f", [1, 2, 3, 17, 64, 128, 168, 169, 170, 238, 239, 240, 1023,
                                   1024, 8192])
    def test_h100_sweep(self, f, dtype):
        itemsize = torch.empty((), dtype=dtype).element_size()
        for with_rhs in (False, True):
            f_max = H100_STAGED_MAX[(itemsize, with_rhs)]
            want = "staged" if f <= f_max else "global" if f < 1024 else "wide"
            assert cuda_impl.lu_path(f, itemsize, H100_SMEM, with_rhs) == want

    @pytest.mark.parametrize("with_rhs", [False, True])
    @pytest.mark.parametrize("itemsize", [4, 8])
    def test_column_bound(self, itemsize, with_rhs):
        big = 2**30
        assert _staged_max(itemsize, with_rhs, big) == cuda_impl.LU_STAGED_MAX_F == 256
        assert cuda_impl.lu_path(256, itemsize, big, with_rhs) == "staged"
        assert cuda_impl.lu_path(257, itemsize, big, with_rhs) == "global"
        with pytest.raises(ValueError, match="staged path takes f <= 256"):
            cuda_impl.check_lu_path("x", "staged", 257, itemsize, big, with_rhs)

    def test_unknown_path(self):
        with pytest.raises(ValueError, match="unknown elimination path"):
            cuda_impl.check_lu_path("x", "blocked", 128, 4, H100_SMEM)

    @pytest.mark.parametrize("op", ["batched_lu_factor", "batched_linsolve"])
    def test_wrappers_refuse_an_unknown_path_before_the_launch(self, op):
        A = torch.eye(4).expand(2, 4, 4).contiguous()
        args = (A,) if op == "batched_lu_factor" else (A, torch.ones(2, 4))
        with pytest.raises(ValueError, match="unknown elimination path"):
            getattr(cuda_impl, op)(*args, path="blocked")
        # a known path goes on to the device check
        with pytest.raises(ValueError, match="CUDA tensors"):
            getattr(cuda_impl, op)(*args, path="staged")


# fused_newton_iter's widest f at H100_SMEM: itemsize -> f, per body.
H100_PANEL_MAX = {4: 53388, 8: 25736}
H100_COLUMN_MAX = {4: 29006, 8: 14503}
# The limits above and one below the panel body's ring (16 KiB), where only
# the column body fits.
NEWTON_LIMITS = LIMITS[:3] + (16 * 1024,)


def _max_fitting(smem_bytes, itemsize, limit):
    """The widest f whose ``smem_bytes(f, itemsize)`` fits ``limit`` (0 if
    none): the bytes grow with f, so bisect."""
    lo, hi = 0, limit + 1
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if smem_bytes(mid, itemsize) <= limit else (lo, mid)
    return lo


class TestNewtonIterBody:
    def test_smem_layout(self):
        # two mbarriers and a 32-row tile (row stride 32 + 16 / itemsize) per
        # ring slot, 4 slots in float32 and 3 in float64, then x rounded up
        # to 16 bytes
        assert cuda_impl.panel_smem_bytes(128, 4) == 16 * 4 + 4 * 32 * 36 * 4 + 512 == 19008
        assert cuda_impl.panel_smem_bytes(128, 8) == 16 * 3 + 3 * 32 * 34 * 8 + 1024 == 27184
        assert cuda_impl.panel_smem_bytes(3, 4) == 16 * 4 + 4 * 32 * 36 * 4 + 16
        assert cuda_impl.column_smem_bytes(128, 4) == 1024  # x and delta

    @pytest.mark.parametrize("itemsize", [4, 8])
    def test_h100_limits(self, itemsize):
        assert _max_fitting(cuda_impl.panel_smem_bytes, itemsize,
                            H100_SMEM) == H100_PANEL_MAX[itemsize]
        assert _max_fitting(cuda_impl.column_smem_bytes, itemsize,
                            H100_SMEM) == H100_COLUMN_MAX[itemsize]
        # the panel body takes every width the column body took, and more
        for f in (33, 128, 4096, 8192, H100_COLUMN_MAX[itemsize], H100_PANEL_MAX[itemsize]):
            assert cuda_impl.newton_iter_body(f, itemsize, H100_SMEM) == "panel"
        for f in (1, 2, 3, 32):  # the small stiff systems: a warp per instance
            assert cuda_impl.newton_iter_body(f, itemsize, H100_SMEM) == "warp"

    @pytest.mark.parametrize("limit", NEWTON_LIMITS)
    @pytest.mark.parametrize("itemsize", [4, 8])
    def test_boundaries(self, itemsize, limit):
        p_max = _max_fitting(cuda_impl.panel_smem_bytes, itemsize, limit)
        c_max = _max_fitting(cuda_impl.column_smem_bytes, itemsize, limit)
        widths = {1, 2, 3, 32, 33, 128, p_max, p_max + 1, c_max, c_max + 1}
        for f in sorted(widths - {0}):
            body = cuda_impl.newton_iter_body(f, itemsize, limit)
            assert body == ("warp" if f <= 32 else "panel" if f <= p_max else "column")
            fits = {"warp": f <= 32, "panel": f <= p_max, "column": f <= c_max}
            for name, ok in fits.items():
                if ok:
                    cuda_impl.check_newton_iter_body("x", name, f, itemsize, limit)
                else:
                    with pytest.raises(ValueError, match=f"the {name} body (needs|takes)"):
                        cuda_impl.check_newton_iter_body("x", name, f, itemsize, limit)

    def test_only_the_column_body_fits_below_the_ring(self):
        limit = 16 * 1024
        assert _max_fitting(cuda_impl.panel_smem_bytes, 4, limit) == 0
        assert cuda_impl.newton_iter_body(2, 4, limit) == "warp"  # static shared memory
        assert cuda_impl.newton_iter_body(33, 4, limit) == "column"
        assert cuda_impl.newton_iter_body(2048, 4, limit) == "column"
        with pytest.raises(ValueError, match="column body needs"):
            cuda_impl.check_newton_iter_body("x", "column", 2049, 4, limit)

    def test_unknown_body(self):
        with pytest.raises(ValueError, match="unknown body"):
            cuda_impl.check_newton_iter_body("x", "blocked", 128, 4, H100_SMEM)

    @pytest.mark.parametrize("itemsize", [4, 8])
    def test_warp_body_width(self, itemsize):
        for f in (1, 2, 3, 31, 32):
            cuda_impl.check_newton_iter_body("x", "warp", f, itemsize, H100_SMEM)
        with pytest.raises(ValueError, match="the warp body takes f <= 32"):
            cuda_impl.check_newton_iter_body("x", "warp", 33, itemsize, H100_SMEM)

    def test_wrapper_refuses_an_unknown_body_before_the_launch(self):
        lu = torch.eye(4).expand(2, 4, 4).contiguous()
        perm = torch.arange(4, dtype=torch.int32).expand(2, 4).contiguous()
        k, fk = torch.ones(2, 4), torch.zeros(2, 4)
        active = torch.ones(2, dtype=torch.bool)
        with pytest.raises(ValueError, match="unknown body"):
            cuda_impl.fused_newton_iter(lu, perm, k, fk, active, 1e-3, body="blocked")
        # a known body goes on to the device check
        for body in ("warp", "panel", "column", None):
            with pytest.raises(ValueError, match="CUDA tensors"):
                cuda_impl.fused_newton_iter(lu, perm, k, fk, active, 1e-3, body=body)


# The device's opt-in shared memory per block on an H100 (NVIDIA H100 80GB
# HBM3), as rt_fused_step_max_smem() reports it: the row body has no static
# shared memory.  The widest row body there: itemsize -> f.
H100_ROW_SMEM = 232448
H100_ROW_MAX = {4: 19364, 8: 9682}
ROW_LIMITS = (H100_ROW_SMEM, 163 * 1024, 48 * 1024, 1024)


class TestFusedStepPolyBody:
    def test_smem_layout(self):
        # 80 bytes for the row's inputs and the decision, then r, y, f0, each
        # padded to 16 bytes
        assert cuda_impl.row_smem_bytes(784, 4) == 80 + 3 * 3136 == 9488
        assert cuda_impl.row_smem_bytes(784, 8) == 80 + 3 * 6272
        assert cuda_impl.row_smem_bytes(1, 4) == 80 + 3 * 16
        assert cuda_impl.row_smem_bytes(5, 8) == 80 + 3 * 48
        assert cuda_impl.row_smem_bytes(0, 4) == 80

    @pytest.mark.parametrize("itemsize", [4, 8])
    def test_h100_limits(self, itemsize):
        f_max = H100_ROW_MAX[itemsize]
        assert _max_fitting(cuda_impl.row_smem_bytes, itemsize, H100_ROW_SMEM) == f_max
        for f in (1, 2, 3, 32, 128, 784, 4096, f_max):  # step_bench: 784
            assert cuda_impl.fused_step_poly_body(f, itemsize, H100_ROW_SMEM) == "row"
        for f in (f_max + 1, 10**6):
            assert cuda_impl.fused_step_poly_body(f, itemsize, H100_ROW_SMEM) == "warp"

    @pytest.mark.parametrize("limit", ROW_LIMITS)
    @pytest.mark.parametrize("itemsize", [4, 8])
    def test_boundaries(self, itemsize, limit):
        r_max = _max_fitting(cuda_impl.row_smem_bytes, itemsize, limit)
        widths = {1, 2, 31, 33, 784, r_max, r_max + 1}
        for f in sorted(widths - {0}):
            body = cuda_impl.fused_step_poly_body(f, itemsize, limit)
            assert body == ("row" if f <= r_max else "warp")
            cuda_impl.check_fused_step_poly_body("x", body, f, itemsize, limit)
            cuda_impl.check_fused_step_poly_body("x", "warp", f, itemsize, limit)
            if f <= r_max:
                cuda_impl.check_fused_step_poly_body("x", "row", f, itemsize, limit)
            else:
                with pytest.raises(ValueError, match="the row body needs"):
                    cuda_impl.check_fused_step_poly_body("x", "row", f, itemsize, limit)

    def test_only_the_warp_body_below_a_row(self):
        # 1024 bytes hold a float32 row of f <= 76 only
        assert _max_fitting(cuda_impl.row_smem_bytes, 4, 1024) == 76
        assert cuda_impl.fused_step_poly_body(76, 4, 1024) == "row"
        assert cuda_impl.fused_step_poly_body(77, 4, 1024) == "warp"
        with pytest.raises(ValueError, match="the row body needs 1040 bytes"):
            cuda_impl.check_fused_step_poly_body("x", "row", 77, 4, 1024)

    def test_unknown_body(self):
        with pytest.raises(ValueError, match="unknown body"):
            cuda_impl.check_fused_step_poly_body("x", "block", 784, 4, H100_ROW_SMEM)

    def test_wrapper_refuses_an_unknown_body_before_the_launch(self):
        b, f = 2, 4
        y = torch.ones(b, f)
        cols = [torch.ones(b) for _ in range(4)]
        mask = torch.ones(b, dtype=torch.bool)
        kw = dict(a=np.zeros((2, 2)), c=np.zeros(2), b_sol=[0.5, 0.5], b_err=[0.5, -0.5],
                  poly=(0.0, -1.0), ctrl=(0.7, 0.0, 0.0, 0.9, 0.2, 10.0, 0.0, math.inf),
                  want_coeffs=False, fsal=False)
        args = (y, -y, *cols, mask, torch.ones(b), torch.ones(b), 1e-6, 1e-4)
        with pytest.raises(ValueError, match="unknown body"):
            cuda_impl.fused_step_poly(*args, body="block", **kw)
        # a known body goes on to the device check
        for body in ("warp", "row", None):
            with pytest.raises(ValueError, match="CUDA tensors"):
                cuda_impl.fused_step_poly(*args, body=body, **kw)


class TestFusedStepBody:
    """``fused_step``'s body: its row body has ``fused_step_poly``'s shared
    memory (``row_smem_bytes``), so the same limits."""

    @pytest.mark.parametrize("itemsize", [4, 8])
    def test_h100_limits(self, itemsize):
        f_max = H100_ROW_MAX[itemsize]
        # vdp_table3 2, robertson 3, allen_cahn_full 128, full_width 784
        for f in (1, 2, 3, 5, 32, 128, 784, 4096, f_max):
            assert cuda_impl.fused_step_body(f, itemsize, H100_ROW_SMEM) == "row"
            cuda_impl.check_fused_step_poly_body("x", "row", f, itemsize, H100_ROW_SMEM)
        for f in (f_max + 1, 10**6):
            assert cuda_impl.fused_step_body(f, itemsize, H100_ROW_SMEM) == "warp"
            with pytest.raises(ValueError, match="the row body needs"):
                cuda_impl.check_fused_step_poly_body("x", "row", f, itemsize, H100_ROW_SMEM)

    @pytest.mark.parametrize("limit", ROW_LIMITS)
    @pytest.mark.parametrize("itemsize", [4, 8])
    def test_boundaries(self, itemsize, limit):
        r_max = _max_fitting(cuda_impl.row_smem_bytes, itemsize, limit)
        for f in sorted({1, 2, 3, 31, 33, 128, 784, r_max, r_max + 1} - {0}):
            body = cuda_impl.fused_step_body(f, itemsize, limit)
            assert body == ("row" if f <= r_max else "warp")
            assert body == cuda_impl.fused_step_poly_body(f, itemsize, limit)
            cuda_impl.check_fused_step_poly_body("x", body, f, itemsize, limit)
            cuda_impl.check_fused_step_poly_body("x", "warp", f, itemsize, limit)
            if f > r_max:
                with pytest.raises(ValueError, match="the row body needs"):
                    cuda_impl.check_fused_step_poly_body("x", "row", f, itemsize, limit)

    @pytest.mark.parametrize("body", ["block", "poly", 1, None])
    def test_unknown_body(self, body):
        with pytest.raises(ValueError, match="unknown body"):
            cuda_impl.check_fused_step_poly_body("x", body, 784, 4, H100_ROW_SMEM)

    def test_bodies_are_numbered_as_the_entry_takes_them(self):
        assert cuda_impl.STEP_BODIES == {"warp": 0, "row": 1}
        assert cuda_impl.body_launches["fused_step"].keys() == cuda_impl.STEP_BODIES.keys()

    @staticmethod
    def _args(b=2, f=4):
        y = torch.ones(b, f)
        K = torch.ones(2, b, f)
        cols = [torch.ones(b) for _ in range(4)]
        mask = torch.ones(b, dtype=torch.bool)
        kw = dict(b_sol=[0.5, 0.5], b_err=[0.5, -0.5],
                  ctrl=(0.7, 0.0, 0.0, 0.9, 0.2, 10.0, 0.0, math.inf), want_coeffs=False)
        return (y, K, K[-1], *cols, mask, torch.ones(b), torch.ones(b), 1e-6, 1e-4), kw

    @pytest.mark.parametrize("body", ["block", "poly", 2])
    def test_wrapper_refuses_an_unknown_body_before_the_launch(self, body):
        args, kw = self._args()
        before = dict(cuda_impl.launches)
        with pytest.raises(ValueError, match="unknown body"):
            cuda_impl.fused_step(*args, body=body, **kw)
        assert cuda_impl.launches == before

    @pytest.mark.parametrize("body", ["warp", "row", None])
    def test_wrapper_takes_a_known_body_to_the_device_check(self, body):
        args, kw = self._args()
        with pytest.raises(ValueError, match="CUDA tensors"):
            cuda_impl.fused_step(*args, body=body, **kw)
        with pytest.raises(ValueError, match="CUDA tensors"):
            cuda_impl.fused_step(*args, body=body, failed=args[7], f0=args[0], **kw)

    @pytest.mark.parametrize("itemsize", [4, 8])
    def test_row_body_refused_where_the_row_does_not_fit(self, itemsize):
        """The picker checks the caller's body against the device's limit
        before the launch: the row body past the widest row raises, the
        default falls back to the warp body there."""
        y = torch.ones(1, H100_ROW_MAX[itemsize] + 1,
                       dtype=torch.float32 if itemsize == 4 else torch.float64)

        class Lib:
            @staticmethod
            def rt_fused_step_max_smem():
                return H100_ROW_SMEM

        device = torch.device("cuda", 7)  # a device index no test leaves a limit for
        cuda_impl._smem_limits[("rt_fused_step_max_smem", 7)] = H100_ROW_SMEM
        try:
            y_dev = mock.Mock(wraps=y, shape=y.shape, device=device)
            y_dev.element_size.return_value = itemsize
            pick = cuda_impl._row_body_picker("fused_step", "row", y_dev)
            with pytest.raises(ValueError, match="the row body needs"):
                pick(Lib)
            pick = cuda_impl._row_body_picker("fused_step", None, y_dev)
            assert pick(Lib) == "warp"
            y_dev.shape = (1, H100_ROW_MAX[itemsize])
            assert pick(Lib) == "row"
        finally:
            del cuda_impl._smem_limits[("rt_fused_step_max_smem", 7)]


class TestDenseBodies:
    """``error_norm``'s body (the row body above ``NORM_WARP_MAX_F`` entries
    a row up to ``NORM_ROW_MAX_F``, whose row it holds in shared memory, the
    wide body above that up to ``NORM_WIDE_MAX_F``, the warp body elsewhere)
    and ``interp_eval``'s (the cell body up to
    ``INTERP_CELL_MAX_F``, the row body above; both take every width)."""

    @pytest.mark.parametrize("f", [1, 2, 16, 17, 31, 32, 33, 48, 63, 64, 65, 96, 128, 783,
                                   784, 785, 4096, 4097, 10**6, 5242880, 2**31 - 1, 2**31])
    def test_boundaries(self, f):
        want = ("warp" if f <= cuda_impl.NORM_WARP_MAX_F else
                "row" if f <= cuda_impl.NORM_ROW_MAX_F else
                "wide" if f <= cuda_impl.NORM_WIDE_MAX_F else "warp")
        assert cuda_impl.error_norm_body(f) == want
        assert cuda_impl.interp_eval_body(f) == ("cell" if f <= cuda_impl.INTERP_CELL_MAX_F
                                                 else "row")

    @pytest.mark.parametrize("f", [1, 64, 65, 4096, 4097, 10**6])
    @pytest.mark.parametrize("body", ["warp", "row", "wide"])
    def test_row_body_only_where_its_row_fits(self, f, body):
        """The warp body takes every width, the row body up to
        ``NORM_ROW_MAX_F`` entries (32 KB a row in float64, under the 48 KB a
        block has without opting in); the chosen body always passes."""
        assert cuda_impl.NORM_ROW_MAX_F * 8 <= 48 * 1024
        cuda_impl.check_error_norm_body(cuda_impl.error_norm_body(f), f)
        if body == "row" and f > cuda_impl.NORM_ROW_MAX_F:
            with pytest.raises(ValueError, match="row body"):
                cuda_impl.check_error_norm_body(body, f)
        else:
            cuda_impl.check_error_norm_body(body, f)

    @pytest.mark.parametrize("f", [1, 4097, 2**31 - 1, 2**31, 2**40])
    def test_wide_body_only_where_its_index_holds(self, f):
        """The wide body takes every width its 32-bit column index holds; the
        warp body takes the wider rows."""
        if f > cuda_impl.NORM_WIDE_MAX_F:
            with pytest.raises(ValueError, match="wide body"):
                cuda_impl.check_error_norm_body("wide", f)
            assert cuda_impl.error_norm_body(f) == "warp"
        else:
            cuda_impl.check_error_norm_body("wide", f)

    @pytest.mark.parametrize("f, itemsize, want", [
        (1, 4, 4), (4097, 4, 4100), (4100, 4, 4100), (4097, 8, 4098), (5242880, 4, 5242880),
        (3213072, 8, 3213072)])
    def test_wide_scratch_rows_start_aligned(self, f, itemsize, want):
        width = cuda_impl.norm_scratch_width(f, itemsize)
        assert width == want and width * itemsize % 16 == 0 and width >= f

    def test_main_shapes(self):
        """vdp_table3's two entries a row take the narrow bodies, full_width's
        784 the row bodies."""
        assert cuda_impl.error_norm_body(2) == "warp"
        assert cuda_impl.interp_eval_body(2) == "cell"
        assert cuda_impl.error_norm_body(784) == "row"
        assert cuda_impl.interp_eval_body(784) == "row"
        # the joint backsolve's row at full_width, the ODE-depth LM's rows
        assert cuda_impl.error_norm_body(3213072) == "wide"
        assert cuda_impl.error_norm_body(2048 * 2560) == "wide"
        for limit in (cuda_impl.NORM_WARP_MAX_F, cuda_impl.INTERP_CELL_MAX_F):
            assert 2 <= limit < 784

    def test_bodies_are_numbered_as_the_entry_takes_them(self):
        assert cuda_impl.ERROR_NORM_BODIES == {"warp": 0, "row": 1, "wide": 2}
        assert cuda_impl.INTERP_BODIES == {"cell": 0, "row": 1}
        for name, table in (("error_norm", cuda_impl.ERROR_NORM_BODIES),
                            ("interp_eval", cuda_impl.INTERP_BODIES)):
            assert cuda_impl.body_launches[name].keys() == table.keys()

    @staticmethod
    def _interp_args(b=2, n=4, f=3):
        coeffs = tuple(torch.ones(b, f) for _ in range(4))
        return coeffs, torch.ones(b, n), torch.ones(b, n, dtype=torch.bool), torch.ones(b, n, f)

    @pytest.mark.parametrize("body", ["block", "cell", 1])
    def test_error_norm_refuses_an_unknown_body_before_the_launch(self, body):
        y = torch.ones(2, 3)
        before = dict(cuda_impl.launches)
        with pytest.raises(ValueError, match="unknown body"):
            cuda_impl.error_norm(y, y, y, 1e-6, 1e-3, body=body)
        assert cuda_impl.launches == before

    @pytest.mark.parametrize("body", ["block", "warp", 0])
    def test_interp_eval_refuses_an_unknown_body_before_the_launch(self, body):
        before = dict(cuda_impl.launches)
        with pytest.raises(ValueError, match="unknown body"):
            cuda_impl.interp_eval(*self._interp_args(), body=body)
        assert cuda_impl.launches == before

    @pytest.mark.parametrize("body", ["warp", "row", "wide", None])
    def test_error_norm_takes_a_known_body_to_the_device_check(self, body):
        y = torch.ones(2, 3)
        with pytest.raises(ValueError, match="CUDA tensors"):
            cuda_impl.error_norm(y, y, y, 1e-6, 1e-3, body=body)

    @pytest.mark.parametrize("body", ["cell", "row", None])
    def test_interp_eval_takes_a_known_body_to_the_device_check(self, body):
        with pytest.raises(ValueError, match="CUDA tensors"):
            cuda_impl.interp_eval(*self._interp_args(), body=body)


SIGNS = (-2.5, -1.0, -0.0, 0.0, 1.0, 3.0, math.nan)


def _crossed_by_masks(v_prev, v_new, fired, accept, up_only, down_only):
    """fused_event_detect's test as the kernel runs it, from the two masks."""
    up = (v_prev <= 0) & (v_new >= 0)
    down = (v_prev >= 0) & (v_new <= 0)
    E = v_prev.shape[1]
    u = torch.tensor([bool(up_only >> e & 1) for e in range(E)])
    d = torch.tensor([bool(down_only >> e & 1) for e in range(E)])
    crossed = torch.where(u, up, torch.where(d, down, up | down))
    crossed = crossed & ((v_prev != 0) | (v_new != 0))
    return crossed & ~fired & accept[:, None], torch.where(accept[:, None], v_new, v_prev)


class TestDirectionMasks:
    @pytest.mark.parametrize("E", [1, 64])
    @pytest.mark.parametrize("sign", SIGNS)
    def test_every_sign(self, E, sign):
        up_only, down_only = cuda_impl.direction_masks((sign,) * E)
        full = (1 << E) - 1
        assert up_only == (full if sign > 0 else 0)
        assert down_only == (full if sign < 0 else 0)

    @pytest.mark.parametrize("E", [1, 2, 63, 64])
    def test_mixed_directions(self, E):
        rng = np.random.default_rng(E)
        directions = tuple(float(rng.choice(SIGNS)) for _ in range(E))
        up_only, down_only = cuda_impl.direction_masks(directions)
        assert up_only < 2**64 and down_only < 2**64 and not up_only & down_only
        for e, d in enumerate(directions):
            assert bool(up_only >> e & 1) == (d > 0)
            assert bool(down_only >> e & 1) == (d < 0)

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    @pytest.mark.parametrize("E", [1, 64])
    def test_masks_decide_as_the_plain_version(self, dtype, E):
        """The kernel's crossing test, run from the masks on the CPU, equals
        ref.fused_event_detect bitwise for every direction."""
        *args, cycle = event_checks.to_torch(event_checks.detect_inputs(E, 97, E, dtype), "cpu")
        rng = np.random.default_rng(E + 1)
        mixed = tuple(float(rng.choice(SIGNS)) for _ in range(E))
        for directions in (cycle, mixed, *((s,) * E for s in SIGNS)):
            masks = cuda_impl.direction_masks(directions)
            event_checks.assert_bitwise("detect", _crossed_by_masks(*args, *masks),
                                        ref.fused_event_detect(*args, directions=directions))

    def test_too_many_events(self):
        with pytest.raises(ValueError, match="at most 64 events"):
            cuda_impl.direction_masks((1.0,) * 65)
