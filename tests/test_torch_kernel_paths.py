"""The choice of body or path of the two kernels that have more than one,
on the CPU: ``cuda_impl.flash_body`` (the attention's wgmma or FFMA body)
and ``cuda_impl.lu_path`` (the elimination staged in shared memory, in
device memory, or column by column over the card), on every boundary, and
the wrappers' own checks, which raise ``ValueError`` wherever the C entries
would refuse a body or path -- before any launch, so a refusal never
reaches the card.

The card tests (``tests/test_torch_kernels_card.py``) hold each body and
path to the plain version and the staged elimination bitwise to the
device-memory one.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import cuda_impl  # noqa: E402

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
