"""Wrappers around the CUDA kernels in ``csrc/`` (``solver_kernels.cu``,
``fused_step.cu``, ``events.cu``, ``linalg.cu``, ``flash_attn.cu``).

Each wrapper checks device, dtype (float32 or float64; float32 or bfloat16
for the attention), shape and
contiguity, allocates its outputs with ``torch.empty``, launches on
``torch.cuda.current_stream()`` and raises when the launch reports an error.
It never falls back to the plain version: a tensor the kernel does not take
is an error.  ``launches[name]`` counts the launches of each kernel, and
nothing else adds to it; ``body_launches`` splits the count of the kernels
with more than one body or path by the one that ran.

Seven kernels have more than one body, each chosen by one function here and
passed to the C entry, which refuses a body that does not take the shape:
``flash_attention_fwd`` (``flash_body``: the wgmma body for bfloat16 with
hd <= 128, FFMA otherwise), the elimination of ``batched_lu_factor`` and
``batched_linsolve`` (``lu_path``: staged in shared memory where the matrix
fits, in device memory above that, column by column over the card from
``LU_WIDE_F`` columns), ``fused_newton_iter`` (``newton_iter_body``: a warp
per instance up to ``WARP_MAX_F`` columns, then the panel substitution, the
LU streamed through shared memory, wherever its ring and vector fit; the
column loop otherwise), ``fused_step_poly`` (``fused_step_poly_body``: a
block per row wherever three of the row's planes fit in shared memory, a
warp per row otherwise), ``fused_step`` (``fused_step_body``: the same
rule), ``error_norm`` (``error_norm_body``: a block per row above
``NORM_WARP_MAX_F`` entries up to ``NORM_ROW_MAX_F``, whose row fits in
shared memory, a warp per row otherwise) and ``interp_eval``
(``interp_eval_body``: a thread per cell up to ``INTERP_CELL_MAX_F`` entries,
a block per row above; either body takes every shape).
The wrappers check a body or path given by the caller with the same rules
and raise ``ValueError`` before any launch.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

launches = {"stage_accum": 0, "fused_update": 0, "error_norm": 0, "interp_eval": 0,
            "fused_step": 0, "fused_step_poly": 0, "masked_bisect_refine": 0,
            "fused_event_detect": 0, "fused_event_commit": 0, "batched_linsolve": 0,
            "batched_lu_factor": 0, "fused_newton_iter": 0, "masked_newton_update": 0,
            "flash_attention_fwd": 0}

# The elimination paths of csrc/linalg.cu and the attention bodies of
# csrc/flash_attn.cu, numbered as their C entries take them.
LU_PATHS = {"staged": 0, "global": 1, "wide": 2}
LU_WIDE_F = 1024  # the wide path's first width
LU_STAGED_MAX_F = 256  # kStagedMaxF of csrc/linalg.cu: a lane's columns in registers
FLASH_BODIES = {"wgmma": 0, "ffma": 1}
NEWTON_BODIES = {"panel": 0, "column": 1, "warp": 2}
WARP_MAX_F = 32  # kWarpMaxF of csrc/linalg.cu: a lane per row
# The panel body's ring in csrc/linalg_common.cuh: kRingStages tiles of
# kPanel rows at a row stride of kPanel + 16 / itemsize entries, two 8-byte
# mbarriers a tile.
PANEL = 32
PANEL_STAGES = {4: 4, 8: 3}

# fused_step_poly's bodies in csrc/fused_step.cu: a warp per row, or a block
# per row with three of the row's planes in shared memory (row_smem_bytes),
# as fast or faster at every width measured (PERF.md).  fused_step has the
# same two, numbered alike: its row body reads the s stage planes where
# fused_step_poly's runs the recursion, in the same shared memory.
POLY_BODIES = {"warp": 0, "row": 1}
STEP_BODIES = POLY_BODIES

# error_norm's bodies in csrc/solver_kernels.cu: a warp per row,
# lane-strided (the first design), or a block per row, 16-byte chunks and the
# scaled errors folded from shared memory, which holds the whole row.  Both
# fold in the fused step kernels' order, so they give the same bits.  On an
# H100 the warp body was as fast or faster up to f = 64 and the row body from
# f = 96 on (b = 1024, float32; PERF.md).
ERROR_NORM_BODIES = {"warp": 0, "row": 1}
NORM_WARP_MAX_F = 64  # the widest row that takes the warp body below the row body
NORM_ROW_MAX_F = 4096  # the widest row the row body takes (kNormRowMaxF)
# interp_eval's bodies: a thread per (row, point) cell, or a block per row
# (the mask ballotted into shared memory, each thread's coefficient chunks
# read once); each writes the masked cells only, with the same bits.  The
# cell body was the faster up to f = 32, the row body from f = 48 on.
INTERP_BODIES = {"cell": 0, "row": 1}
INTERP_CELL_MAX_F = 32  # the widest row that takes the cell body

body_launches = {"flash_attention_fwd": dict.fromkeys(FLASH_BODIES, 0),
                 "batched_lu_factor": dict.fromkeys(LU_PATHS, 0),
                 "batched_linsolve": dict.fromkeys(LU_PATHS, 0),
                 "fused_newton_iter": dict.fromkeys(NEWTON_BODIES, 0),
                 "fused_step_poly": dict.fromkeys(POLY_BODIES, 0),
                 "fused_step": dict.fromkeys(STEP_BODIES, 0),
                 "error_norm": dict.fromkeys(ERROR_NORM_BODIES, 0),
                 "interp_eval": dict.fromkeys(INTERP_BODIES, 0)}

_DTYPES = {torch.float32: 0, torch.float64: 1}

# Why a wrapper refuses an input that requires grad while grad mode is on.
# The four explicit-path kernels have their backward in kernels/autograd.py,
# which ops.py reaches; the others have none on the card yet.
_WITH_FUNCTION = ("the CUDA kernel has no backward of its own: differentiate through "
                  "repro_torch.kernels.ops, whose autograd Function holds it")
_NO_BACKWARD = {
    None: ("the CUDA kernel has no backward yet (ROADMAP A-18); solve under "
           "torch.no_grad(), on the CPU, or through BacksolveAdjoint to differentiate"),
    "flash_attention_fwd": ("the CUDA kernel has no backward yet (ROADMAP A-17); run the "
                            "attention under torch.no_grad() or on the CPU to differentiate"),
    **dict.fromkeys(("stage_accum", "fused_update", "error_norm", "interp_eval"),
                    _WITH_FUNCTION),
}


def _check(name, dtype, *tensors):
    for t in tensors:
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                             f"{getattr(t, 'device', type(t).__name__)}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel takes contiguous tensors")
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(f"{name}: {_NO_BACKWARD.get(name, _NO_BACKWARD[None])}")


def _dtype_code(name, t):
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name}: the CUDA kernel takes float32 or float64, got {t.dtype}")
    return _DTYPES[t.dtype]


def _same_device(name, *tensors):
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors lie on several devices {sorted(map(str, devices))}")


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(name, code):
    if code != 0:
        msg = _build.load().rt_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}: {msg}")


def _coeff_array(name, values, lib):
    vals = np.asarray(values, dtype=np.float64).reshape(-1).tolist()
    limit = lib.rt_max_stages()
    if len(vals) > limit:
        raise ValueError(f"{name}: at most {limit} coefficients, got {len(vals)}")
    return (ctypes.c_double * max(len(vals), 1))(*vals), len(vals)


def stage_accum(y, dt, K, coeffs):
    """CUDA ``stage_accum``: y + dt[:, None] * sum_j coeffs[j] * K[j]."""
    code = _dtype_code("stage_accum", y)
    _check("stage_accum", y.dtype, y, dt, K)
    _same_device("stage_accum", y, dt, K)
    b, f = y.shape
    lib = _build.load()
    arr, nj = _coeff_array("stage_accum", coeffs, lib)
    if dt.shape != (b,) or K.ndim != 3 or K.shape[1:] != (b, f) or K.shape[0] != nj:
        raise ValueError(f"stage_accum: shapes y {tuple(y.shape)}, dt {tuple(dt.shape)}, "
                         f"K {tuple(K.shape)}, {nj} coefficients do not agree")
    out = torch.empty_like(y)
    with torch.cuda.device(y.device):
        rc = lib.rt_stage_accum(code, y.data_ptr(), dt.data_ptr(), K.data_ptr(), arr, nj,
                                out.data_ptr(), b, f, _stream(y.device))
    _raise_on("stage_accum", rc)
    launches["stage_accum"] += 1
    return out


def fused_update(y, K, dt, b_sol, b_err):
    """CUDA ``fused_update``: returns (y + dt * (b_sol . K), dt * (b_err . K))."""
    code = _dtype_code("fused_update", y)
    _check("fused_update", y.dtype, y, K, dt)
    _same_device("fused_update", y, K, dt)
    b, f = y.shape
    lib = _build.load()
    bs, ns = _coeff_array("fused_update", b_sol, lib)
    be, ne = _coeff_array("fused_update", b_err, lib)
    if ne != ns or dt.shape != (b,) or K.ndim != 3 or K.shape != (ns, b, f):
        raise ValueError(f"fused_update: shapes y {tuple(y.shape)}, K {tuple(K.shape)}, "
                         f"dt {tuple(dt.shape)}, {ns}/{ne} weights do not agree")
    y1 = torch.empty_like(y)
    err = torch.empty_like(y)
    with torch.cuda.device(y.device):
        rc = lib.rt_fused_update(code, y.data_ptr(), K.data_ptr(), dt.data_ptr(), bs, be, ns,
                                 y1.data_ptr(), err.data_ptr(), b, f, _stream(y.device))
    _raise_on("fused_update", rc)
    launches["fused_update"] += 1
    return y1, err


def _tolerance(name, tol, b, f, like):
    """(pointer, value, row stride, column stride) of a scalar, (b,) or (b, f)
    tolerance.  A Python number rides by value; a tensor is addressed through
    its broadcast strides (0 on a broadcast axis)."""
    if not isinstance(tol, torch.Tensor):
        return None, float(tol), 0, 0
    _check(name, like.dtype, tol)
    _same_device(name, tol, like)
    if tol.ndim == 1:
        tol = tol[:, None]
    try:
        view = tol.expand(b, f)
    except RuntimeError:
        raise ValueError(f"{name}: tolerance of shape {tuple(tol.shape)} does not "
                         f"broadcast to ({b}, {f})") from None
    return view.data_ptr(), 0.0, view.stride(0), view.stride(1)


def error_norm_body(f):
    """The body of ``error_norm`` at width ``f``: ``"row"`` above
    ``NORM_WARP_MAX_F`` entries a row up to ``NORM_ROW_MAX_F``, else
    ``"warp"`` (which takes every width)."""
    return "row" if NORM_WARP_MAX_F < f <= NORM_ROW_MAX_F else "warp"


def check_error_norm_body(body, f):
    """Raise ValueError where the C entry would refuse ``body`` at width
    ``f``: an unknown body, or the row body above ``NORM_ROW_MAX_F``."""
    _known("error_norm", body, ERROR_NORM_BODIES, "body")
    if body == "row" and f > NORM_ROW_MAX_F:
        raise ValueError(f"error_norm: the row body holds a row of at most {NORM_ROW_MAX_F} "
                         f"entries in shared memory, not f = {f}")


def interp_eval_body(f):
    """The body of ``interp_eval`` at width ``f``: ``"cell"`` up to
    ``INTERP_CELL_MAX_F`` entries a row, else ``"row"`` (both bodies take
    every width)."""
    return "cell" if f <= INTERP_CELL_MAX_F else "row"


def error_norm(err, y0, y1, atol, rtol, body=None):
    """CUDA ``error_norm``: per-row WRMS of err / (atol + rtol * max(|y0|, |y1|)).
    ``body`` overrides ``error_norm_body``'s choice (both give the same bits)."""
    if body is not None:
        _known("error_norm", body, ERROR_NORM_BODIES, "body")
    code = _dtype_code("error_norm", err)
    _check("error_norm", err.dtype, err, y0, y1)
    _same_device("error_norm", err, y0, y1)
    if err.ndim != 2 or y0.shape != err.shape or y1.shape != err.shape:
        raise ValueError(f"error_norm: shapes {tuple(err.shape)}, {tuple(y0.shape)}, "
                         f"{tuple(y1.shape)} do not agree")
    b, f = err.shape
    ap, av, ars, acs = _tolerance("error_norm", atol, b, f, err)
    rp, rv, rrs, rcs = _tolerance("error_norm", rtol, b, f, err)
    body = error_norm_body(f) if body is None else body
    check_error_norm_body(body, f)
    out = torch.empty((b,), dtype=err.dtype, device=err.device)
    lib = _build.load()
    with torch.cuda.device(err.device):
        rc = lib.rt_error_norm(code, ERROR_NORM_BODIES[body], err.data_ptr(), y0.data_ptr(),
                               y1.data_ptr(), ap, av, ars, acs, rp, rv, rrs, rcs,
                               out.data_ptr(), b, f, _stream(err.device))
    _raise_on("error_norm", rc)
    launches["error_norm"] += 1
    body_launches["error_norm"][body] += 1
    return out


def interp_eval(coeffs, x, mask, out, cursor=None, body=None):
    """CUDA ``interp_eval``: writes p(x) into the masked cells of ``out`` IN
    PLACE and returns ``out`` (the unmasked cells are neither read nor
    written; the port updates the dense-output buffer in place to save the
    (b, n, f) round trip).  With ``cursor`` (b,) int64, ``x``/``mask`` are a
    (b, W) window addressing ``out[row, cursor[row] + w]``; the cursor lives
    on the device, so it is not checked here, and a window cell that would
    fall outside ``out`` is left unwritten.  ``body`` overrides
    ``interp_eval_body``'s choice (both give the same bits)."""
    if body is not None:
        _known("interp_eval", body, INTERP_BODIES, "body")
    c0, c1, c2, c3 = coeffs
    code = _dtype_code("interp_eval", out)
    _check("interp_eval", out.dtype, c0, c1, c2, c3, x, out)
    b, n, f = out.shape
    nw = x.shape[1] if x.ndim == 2 else -1
    if (any(c.shape != (b, f) for c in coeffs) or x.shape != (b, nw)
            or mask.shape != (b, nw) or (cursor is None and nw != n) or nw > n):
        raise ValueError(f"interp_eval: shapes coeffs {[tuple(c.shape) for c in coeffs]}, "
                         f"x {tuple(x.shape)}, mask {tuple(mask.shape)}, "
                         f"out {tuple(out.shape)} do not agree")
    if mask.dtype != torch.bool or mask.device != out.device or not mask.is_contiguous():
        raise TypeError("interp_eval: mask must be a contiguous bool tensor on the "
                        "device of out")
    cursor_ptr = None
    if cursor is not None:
        if (cursor.dtype != torch.int64 or cursor.shape != (b,)
                or cursor.device != out.device or not cursor.is_contiguous()):
            raise TypeError("interp_eval: cursor must be a contiguous (b,) int64 tensor "
                            "on the device of out")
        cursor_ptr = cursor.data_ptr()
    _same_device("interp_eval", c0, c1, c2, c3, x, out)
    body = interp_eval_body(f) if body is None else body
    lib = _build.load()
    with torch.cuda.device(out.device):
        rc = lib.rt_interp_eval(code, INTERP_BODIES[body], c0.data_ptr(), c1.data_ptr(),
                                c2.data_ptr(), c3.data_ptr(), x.data_ptr(), mask.data_ptr(),
                                cursor_ptr, out.data_ptr(), b, nw, n, f, _stream(out.device))
    _raise_on("interp_eval", rc)
    launches["interp_eval"] += 1
    body_launches["interp_eval"][body] += 1
    return out


class _FusedStepArgs(ctypes.Structure):
    """``FusedStepArgs`` of ``csrc/fused_step.cu``, field for field."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "y", "K", "f1", "poly", "t", "t_new", "dt_cur", "safe_dt", "prev_inv",
            "prev2_inv", "running", "failed", "f0", "atol", "rtol",
            "y1", "ratio", "accept", "y_out", "f_out", "t_out", "dt_out", "new_inv",
            "new_inv2", "c1", "c2", "c3")]
        + [("atol_val", ctypes.c_double), ("rtol_val", ctypes.c_double)]
        + [(name, ctypes.c_int64) for name in (
            "atol_rs", "atol_cs", "rtol_rs", "rtol_cs", "b", "f")]
        + [(name, ctypes.c_int32) for name in ("s", "npoly", "fsal", "ctrl_mode")]
        + [("ctrl", ctypes.c_double * 8), ("b_sol", ctypes.c_double * 8),
           ("b_err", ctypes.c_double * 8), ("a", ctypes.c_double * 64)]
    )


_CTRL_MODES = {"pid": 0, "fixed": 1}


def _launch_fused(name, launch, y, K, f1, poly, t, t_new, dt_cur, safe_dt, running,
                  prev_inv, prev2_inv, atol, rtol, *, b_sol, b_err, ctrl, want_coeffs,
                  ctrl_mode, failed, f0=None, a=None, fsal=True, pick_body=None):
    """Check the inputs of ``fused_step``/``fused_step_poly``, allocate the
    twelve outputs, launch, and return them as ``ref.fused_step`` does.
    ``launch(lib, code, args, stream, body)`` calls the C entry;
    ``pick_body(lib)`` (None: one body) chooses and checks the body."""
    code = _dtype_code(name, y)
    b, f = y.shape
    s = len(b_sol)
    cols = (t, t_new, dt_cur, safe_dt, prev_inv, prev2_inv)
    planes = ([y, K] + [p for p in (f1, f0, poly) if p is not None])
    _check(name, y.dtype, *planes, *cols)
    for mask in (running, failed):
        if mask is not None:
            _check(name, torch.bool, mask)
    masks = [m for m in (running, failed) if m is not None]
    _same_device(name, *planes, *cols, *masks)
    k_shape = (s, b, f) if a is None else (b, f)
    if (K.shape != k_shape or any(p is not None and p.shape != (b, f) for p in (f1, f0))
            or any(x.shape != (b,) for x in (*cols, *masks))
            or len(b_err) != s or s > 8 or (ctrl_mode == "pid" and len(ctrl) != 8)
            or (poly is not None and (poly.ndim != 2 or poly.shape[1] != f))):
        raise ValueError(f"{name}: shapes y {tuple(y.shape)}, K {tuple(K.shape)}, "
                         f"{s}/{len(b_err)} weights, columns "
                         f"{[tuple(x.shape) for x in (*cols, *masks)]} do not agree")
    if ctrl_mode not in _CTRL_MODES:
        raise ValueError(f"{name}: unknown ctrl_mode {ctrl_mode!r}")
    ap, av, ars, acs = _tolerance(name, atol, b, f, y)
    rp, rv, rrs, rcs = _tolerance(name, rtol, b, f, y)

    def plane():
        return torch.empty_like(y)

    def col(dtype=y.dtype):
        return torch.empty((b,), dtype=dtype, device=y.device)

    y1, y_out, f_out = plane(), plane(), plane()
    ratio, t_out, dt_out, new_inv, new_inv2 = col(), col(), col(), col(), col()
    accept = col(torch.bool)
    c1, c2, c3 = (plane(), plane(), plane()) if want_coeffs else (None, None, None)

    def ptr(x):
        return None if x is None else x.data_ptr()

    args = _FusedStepArgs(
        *(ptr(x) for x in (y, K, f1, poly, t, t_new, dt_cur, safe_dt, prev_inv, prev2_inv,
                           running, failed, f0)),
        ap, rp, *(ptr(x) for x in (y1, ratio, accept, y_out, f_out, t_out, dt_out, new_inv,
                                   new_inv2, c1, c2, c3)),
        av, rv, ars, acs, rrs, rcs, b, f, s,
        0 if poly is None else poly.shape[0], int(bool(fsal)), _CTRL_MODES[ctrl_mode])
    args.ctrl[:len(ctrl)] = [float(x) for x in ctrl]
    args.b_sol[:s] = np.asarray(b_sol, dtype=np.float64).tolist()
    args.b_err[:s] = np.asarray(b_err, dtype=np.float64).tolist()
    if a is not None:
        a = np.asarray(a, dtype=np.float64)
        if a.shape != (s, s):
            raise ValueError(f"{name}: stage matrix of shape {a.shape}, want ({s}, {s})")
        for r in range(s):
            args.a[r * 8:r * 8 + r] = a[r, :r].tolist()
    lib = _build.load()
    if lib.rt_fused_step_args_size() != ctypes.sizeof(_FusedStepArgs):
        raise RuntimeError(f"{name}: FusedStepArgs layout differs between Python and CUDA")
    body = pick_body(lib) if pick_body else None
    with torch.cuda.device(y.device):
        rc = launch(lib, code, ctypes.byref(args), _stream(y.device), body)
    _raise_on(name, rc)
    launches[name] += 1
    if body is not None:
        body_launches[name][body] += 1
    coeffs = (y, c1, c2, c3) if want_coeffs else None
    return y1, ratio, accept, y_out, f_out, t_out, dt_out, new_inv, new_inv2, coeffs


def fused_step(y, K, f1, t, t_new, dt_cur, safe_dt, running, prev_inv, prev2_inv,
               atol, rtol, *, b_sol, b_err, ctrl, want_coeffs, ctrl_mode="pid",
               failed=None, f0=None, body=None):
    """CUDA ``fused_step``: one launch for the combine, the WRMS ratio, the
    controller, the masked commit and the Hermite coefficients (see
    ``ref.fused_step``).  ``failed`` and ``f0`` may be None (null pointers;
    without ``f0`` the kernel reads K[0]).  ``body`` overrides
    ``fused_step_body``'s choice (both give the same bits)."""
    name = "fused_step"
    return _launch_fused(
        name, lambda lib, code, args, stream, chosen: lib.rt_fused_step(
            code, STEP_BODIES[chosen], args, stream),
        y, K, f1, None, t, t_new, dt_cur, safe_dt, running, prev_inv, prev2_inv, atol, rtol,
        b_sol=b_sol, b_err=b_err, ctrl=ctrl, want_coeffs=want_coeffs, ctrl_mode=ctrl_mode,
        failed=failed, f0=f0,
        pick_body=_row_body_picker(name, body, y))


@functools.lru_cache(maxsize=32)
def _poly_rows(poly, f, dtype, device):
    """The (deg + 1, f) coefficient rows of ``poly`` on the card, made once per
    (polynomial, width, dtype, device) and kept: scalars broadcast across the
    features, in the state's dtype."""
    rows = np.stack([np.broadcast_to(np.asarray(c, dtype=np.float64), (f,)) for c in poly])
    return torch.tensor(rows, dtype=dtype, device=device)


def row_smem_bytes(f, itemsize):
    """Shared memory of ``fused_step_poly``'s row body at width ``f``
    (``row_smem_bytes`` of ``csrc/fused_step.cu``): 80 bytes for the row's
    seven (b,) inputs and the decision, then three f-entry planes (the
    scaled errors, y and f0), each rounded up to 16 bytes."""
    return 80 + 3 * (-(-f * itemsize // 16) * 16)


def fused_step_poly_body(f, itemsize, smem_limit):
    """The body of ``fused_step_poly`` at width ``f``: ``"row"`` where its
    shared memory fits ``smem_limit`` bytes, else ``"warp"`` (which takes
    every width)."""
    return "row" if row_smem_bytes(f, itemsize) <= smem_limit else "warp"


# fused_step's row body keeps fused_step_poly's shared memory, so its rule.
fused_step_body = fused_step_poly_body


def check_fused_step_poly_body(name, body, f, itemsize, smem_limit):
    """Raise ValueError where the C entry would refuse ``body`` at width
    ``f``: an unknown body, or the row body with shared memory above
    ``smem_limit`` bytes.  Both bodies take every width that fits; the same
    holds for ``fused_step``'s."""
    _known(name, body, POLY_BODIES, "body")
    if body == "row" and row_smem_bytes(f, itemsize) > smem_limit:
        raise ValueError(f"{name}: the row body needs {row_smem_bytes(f, itemsize)} bytes of "
                         f"shared memory at f = {f}, above the device's limit of {smem_limit} "
                         f"bytes")


def _row_body_picker(name, body, y):
    """Check a caller's ``body`` now, before any launch, and return
    ``pick_body(lib)`` for ``_launch_fused``: the body ``fused_step_poly_body``
    picks at ``y``'s width and the device's shared memory (or the caller's),
    checked against that limit."""
    if body is not None:
        _known(name, body, POLY_BODIES, "body")

    def pick_body(lib):
        f, itemsize = y.shape[1], y.element_size()
        limit = _smem_limit(name, lib, y.device, "rt_fused_step_max_smem")
        chosen = fused_step_poly_body(f, itemsize, limit) if body is None else body
        check_fused_step_poly_body(name, chosen, f, itemsize, limit)
        return chosen

    return pick_body


def fused_step_poly(y, f0, t, t_new, dt_cur, safe_dt, running, prev_inv, prev2_inv,
                    atol, rtol, *, a, c, b_sol, b_err, poly, ctrl, want_coeffs,
                    fsal=True, ctrl_mode="pid", body=None):
    """CUDA ``fused_step_poly``: ``fused_step`` with the stage recursion of
    the polynomial vector field ``poly`` (and the non-FSAL trailing
    evaluation) in the same launch (see ``ref.fused_step_poly``).  ``body``
    overrides ``fused_step_poly_body``'s choice (both give the same bits)."""
    del c  # autonomous polynomial dynamics
    name = "fused_step_poly"
    pick_body = _row_body_picker(name, body, y)
    rows = _poly_rows(tuple(poly), y.shape[1], y.dtype, y.device)
    return _launch_fused(
        name, lambda lib, code, args, stream, chosen: lib.rt_fused_step_poly(
            code, POLY_BODIES[chosen], args, stream),
        y, f0, None, rows, t, t_new, dt_cur, safe_dt, running, prev_inv, prev2_inv, atol, rtol,
        b_sol=b_sol, b_err=b_err, ctrl=ctrl, want_coeffs=want_coeffs, ctrl_mode=ctrl_mode,
        failed=None, a=a, fsal=fsal, pick_body=pick_body)


MAX_EVENTS = 64  # kMaxEvents of csrc/events.cu


def _event_count(name, n, lib):
    limit = lib.rt_max_events()
    if not 1 <= n <= limit:
        raise ValueError(f"{name}: the CUDA kernel takes 1 to {limit} events, got {n}")


def _event_flags(name, values, lib):
    """Per-event int8 flags (a terminal flag) for the kernel's parameter
    block; at most ``rt_max_events()`` events."""
    vals = [int(np.sign(float(v))) for v in values]
    _event_count(name, len(vals), lib)
    return (ctypes.c_int8 * len(vals))(*vals), len(vals)


def direction_masks(directions):
    """``fused_event_detect``'s directions as two bit masks ``(up_only,
    down_only)``: bit e of ``up_only`` set where ``directions[e] > 0``, of
    ``down_only`` where it is < 0, and neither where a crossing counts either
    way (0, or NaN, as ``ref.fused_event_detect`` reads it).  At most
    ``MAX_EVENTS`` directions."""
    if len(directions) > MAX_EVENTS:
        raise ValueError(f"direction_masks: at most {MAX_EVENTS} events, got "
                         f"{len(directions)}")
    up_only = down_only = 0
    for e, d in enumerate(directions):
        d = float(d)
        if d > 0:
            up_only |= 1 << e
        elif d < 0:
            down_only |= 1 << e
    return up_only, down_only


def masked_bisect_refine(coeffs, lo, hi, v_lo, v_mid, active):
    """CUDA ``masked_bisect_refine``: one masked halving of the event bracket
    and the interpolant at the new midpoint (see ``ref.masked_bisect_refine``).
    Returns new tensors ``(lo', hi', v_lo', mid', y_mid')``."""
    c0, c1, c2, c3 = coeffs
    code = _dtype_code("masked_bisect_refine", c0)
    cols = (lo, hi, v_lo, v_mid)
    _check("masked_bisect_refine", c0.dtype, c0, c1, c2, c3, *cols)
    _check("masked_bisect_refine", torch.bool, active)
    _same_device("masked_bisect_refine", c0, c1, c2, c3, *cols, active)
    b, f = c0.shape
    if (f < 1 or any(c.shape != (b, f) for c in coeffs)
            or any(x.shape != (b,) for x in (*cols, active))):
        raise ValueError(f"masked_bisect_refine: shapes coeffs "
                         f"{[tuple(c.shape) for c in coeffs]}, columns "
                         f"{[tuple(x.shape) for x in (*cols, active)]} do not agree")
    outs = [torch.empty_like(lo) for _ in range(4)] + [torch.empty_like(c0)]
    lib = _build.load()
    with torch.cuda.device(c0.device):
        rc = lib.rt_masked_bisect_refine(
            code, *(x.data_ptr() for x in (c0, c1, c2, c3, *cols, active, *outs)), b, f,
            _stream(c0.device))
    _raise_on("masked_bisect_refine", rc)
    launches["masked_bisect_refine"] += 1
    return tuple(outs)


def fused_event_detect(v_prev, v_new, fired, accept, *, directions):
    """CUDA ``fused_event_detect``: the per-event directional sign test and
    the masked carry of the condition values (see ``ref.fused_event_detect``).
    Returns new tensors ``(newly, v_keep)``, ``newly`` bool."""
    code = _dtype_code("fused_event_detect", v_prev)
    _check("fused_event_detect", v_prev.dtype, v_prev, v_new)
    _check("fused_event_detect", torch.bool, fired, accept)
    _same_device("fused_event_detect", v_prev, v_new, fired, accept)
    lib = _build.load()
    E = len(directions)
    _event_count("fused_event_detect", E, lib)
    up_only, down_only = direction_masks(directions)
    b = v_prev.shape[0]
    if (v_prev.shape != (b, E) or v_new.shape != (b, E) or fired.shape != (b, E)
            or accept.shape != (b,)):
        raise ValueError(f"fused_event_detect: shapes v_prev {tuple(v_prev.shape)}, v_new "
                         f"{tuple(v_new.shape)}, fired {tuple(fired.shape)}, accept "
                         f"{tuple(accept.shape)} and {E} directions do not agree")
    newly = torch.empty_like(fired)
    v_keep = torch.empty_like(v_prev)
    with torch.cuda.device(v_prev.device):
        rc = lib.rt_fused_event_detect(
            code, v_prev.data_ptr(), v_new.data_ptr(), fired.data_ptr(), accept.data_ptr(),
            up_only, down_only, E, newly.data_ptr(), v_keep.data_ptr(), b,
            _stream(v_prev.device))
    _raise_on("fused_event_detect", rc)
    launches["fused_event_detect"] += 1
    return newly, v_keep


def fused_event_commit(x, y_ev, newly, y_new, t0, dt, fired, ev_t, ev_y, *, terminal):
    """CUDA ``fused_event_commit``: terminal resolution, the first-crossing
    bookkeeping and the stop outputs (see ``ref.fused_event_commit``).

    ``ev_y`` is updated IN PLACE -- only its cells of the crossings recorded
    this step are written, the rest are neither read nor written -- and is
    returned as ``ev_y'`` (the port saves the (b, E, f) round trip, as
    ``interp_eval`` does for the dense output).  Every other output is a new
    tensor: ``(fired', ev_t', ev_y, stop, t_stop, y_stop, n_new)``."""
    code = _dtype_code("fused_event_commit", y_new)
    _check("fused_event_commit", y_new.dtype, x, y_ev, y_new, t0, dt, ev_t, ev_y)
    _check("fused_event_commit", torch.bool, newly, fired)
    _same_device("fused_event_commit", x, y_ev, newly, y_new, t0, dt, fired, ev_t, ev_y)
    lib = _build.load()
    flags, E = _event_flags("fused_event_commit", terminal, lib)
    b, f = y_new.shape
    if (any(m.shape != (b, E) for m in (x, newly, fired, ev_t))
            or y_ev.shape != (b, E, f) or ev_y.shape != (b, E, f)
            or t0.shape != (b,) or dt.shape != (b,)):
        raise ValueError(f"fused_event_commit: shapes x {tuple(x.shape)}, y_ev "
                         f"{tuple(y_ev.shape)}, y_new {tuple(y_new.shape)}, ev_y "
                         f"{tuple(ev_y.shape)} and {E} terminal flags do not agree")
    fired_out = torch.empty_like(fired)
    ev_t_out = torch.empty_like(ev_t)
    stop = torch.empty((b,), dtype=torch.bool, device=y_new.device)
    t_stop = torch.empty_like(t0)
    y_stop = torch.empty_like(y_new)
    n_new = torch.empty((b,), dtype=torch.int32, device=y_new.device)
    with torch.cuda.device(y_new.device):
        rc = lib.rt_fused_event_commit(
            code, *(v.data_ptr() for v in (x, y_ev, newly, y_new, t0, dt, fired, ev_t, ev_y)),
            flags, E, *(v.data_ptr() for v in (fired_out, ev_t_out, stop, t_stop, y_stop,
                                               n_new)),
            b, f, _stream(y_new.device))
    _raise_on("fused_event_commit", rc)
    launches["fused_event_commit"] += 1
    return fired_out, ev_t_out, ev_y, stop, t_stop, y_stop, n_new


def _square(name, A):
    """(b, f) of a (b, f, f) stack of matrices, or raise."""
    if A.ndim != 3 or A.shape[1] != A.shape[2] or A.shape[0] < 1 or A.shape[1] < 1:
        raise ValueError(f"{name}: expected a (b, f, f) stack of square matrices, got "
                         f"{tuple(A.shape)}")
    return A.shape[0], A.shape[1]


_smem_limits = {}


def _smem_limit(name, lib, device, query="rt_linalg_max_smem"):
    """The dynamic shared memory per block that the kernels behind ``query``
    may ask for: the device's opt-in limit less their static shared memory
    (``rt_linalg_max_smem`` for the linalg kernels, ``rt_fused_step_max_smem``
    for the row bodies of ``fused_step`` and ``fused_step_poly``), read once per
    device."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if (query, index) not in _smem_limits:
        with torch.cuda.device(index):
            limit = getattr(lib, query)()
        if limit < 0:
            raise RuntimeError(f"{name}: cannot read the shared-memory limit of {device}")
        _smem_limits[query, index] = limit
    return _smem_limits[query, index]


def _substitution_fits(name, f, bytes_per_feature, lib, device):
    """The substitution keeps ``bytes_per_feature * f`` bytes in shared
    memory (its vectors): raise above the device's limit."""
    need = f * bytes_per_feature
    limit = _smem_limit(name, lib, device)
    if need > limit:
        raise ValueError(f"{name}: f = {f} needs {need} bytes of shared memory for the "
                         f"substitution, above the device's limit of {limit} bytes "
                         f"(f <= {limit // bytes_per_feature} at this dtype)")


def _row_scale(name, scale, b, f, like):
    """``scale`` (a number, or a tensor broadcasting to (b, f)) as a
    contiguous (b, f) tensor in ``like``'s dtype on its device, as the JAX
    wrapper materializes it."""
    if isinstance(scale, torch.Tensor):
        _same_device(name, scale, like)
    scale = torch.as_tensor(scale, dtype=like.dtype, device=like.device)
    try:
        return torch.broadcast_to(scale, (b, f)).contiguous()
    except RuntimeError:
        raise ValueError(f"{name}: scale of shape {tuple(scale.shape)} does not broadcast to "
                         f"({b}, {f})") from None


def _known(name, choice, table, what):
    if choice not in table:
        raise ValueError(f"{name}: unknown {what} {choice!r}; one of {sorted(table)}")


def staged_smem_bytes(f, itemsize, with_rhs=False):
    """Shared memory of the staged elimination at width ``f``
    (``staged_smem_bytes`` of ``csrc/linalg_common.cuh``): the matrix at row
    stride f + 1 and the f multipliers in the matrix's dtype (``itemsize``
    bytes), the linsolve's right-hand side (``with_rhs``), the int32
    permutation."""
    return itemsize * (f * (f + 1) + f + (f if with_rhs else 0)) + 4 * f


def _staged_fits(f, itemsize, smem_limit, with_rhs):
    return f <= LU_STAGED_MAX_F and staged_smem_bytes(f, itemsize, with_rhs) <= smem_limit


def lu_path(f, itemsize, smem_limit, with_rhs=False):
    """The elimination path of ``batched_lu_factor`` (``with_rhs`` False) or
    ``batched_linsolve`` (True) at width ``f``: ``"wide"`` from
    ``LU_WIDE_F`` columns, else ``"staged"`` where the staged matrix fits
    ``smem_limit`` bytes and f <= ``LU_STAGED_MAX_F``, else ``"global"``."""
    if f >= LU_WIDE_F:
        return "wide"
    return "staged" if _staged_fits(f, itemsize, smem_limit, with_rhs) else "global"


def check_lu_path(name, path, f, itemsize, smem_limit, with_rhs=False):
    """Raise ValueError where the C entry would refuse ``path`` at width
    ``f``: an unknown path, or a staged matrix above ``smem_limit`` bytes or
    ``LU_STAGED_MAX_F`` columns.  The global and wide paths take every width
    (the global one is slow from ``LU_WIDE_F`` columns on, and the wide one
    below)."""
    _known(name, path, LU_PATHS, "elimination path")
    if path == "staged" and not _staged_fits(f, itemsize, smem_limit, with_rhs):
        raise ValueError(f"{name}: the staged path takes f <= {LU_STAGED_MAX_F} within the "
                         f"device's {smem_limit} bytes of shared memory; f = {f} needs "
                         f"{staged_smem_bytes(f, itemsize, with_rhs)} bytes")


def _pick_lu_path(name, path, f, A, lib, with_rhs):
    limit = _smem_limit(name, lib, A.device)
    if path is None:
        path = lu_path(f, A.element_size(), limit, with_rhs)
    check_lu_path(name, path, f, A.element_size(), limit, with_rhs)
    return path


def batched_lu_factor(A, *, path=None):
    """CUDA ``batched_lu_factor``: the packed partial-pivoted LU of each
    (f, f) matrix and the int32 row permutation with ``A[perm] == L @ U``
    (see ``ref.batched_lu_factor``).  ``path`` overrides ``lu_path``'s
    choice of elimination (all three give the same bits).  Returns new
    tensors ``(lu, perm)``."""
    name = "batched_lu_factor"
    code = _dtype_code(name, A)
    if path is not None:
        _known(name, path, LU_PATHS, "elimination path")
    _check(name, A.dtype, A)
    b, f = _square(name, A)
    lib = _build.load()
    path = _pick_lu_path(name, path, f, A, lib, False)
    lu = torch.empty_like(A)
    perm = torch.empty((b, f), dtype=torch.int32, device=A.device)
    with torch.cuda.device(A.device):
        rc = lib.rt_batched_lu_factor(code, LU_PATHS[path], A.data_ptr(), lu.data_ptr(),
                                      perm.data_ptr(), b, f, _stream(A.device))
    _raise_on(name, rc)
    launches[name] += 1
    body_launches[name][path] += 1
    return lu, perm


def batched_linsolve(A, rhs, *, path=None):
    """CUDA ``batched_linsolve``: x with A @ x = rhs per instance, by the LU
    of ``batched_lu_factor`` and the substitution of ``fused_newton_iter``
    (see ``ref.batched_linsolve``).  ``path`` overrides ``lu_path``'s choice
    of elimination: staged, the matrix is factored and substituted in shared
    memory; global and wide, in a scratch copy of A."""
    name = "batched_linsolve"
    code = _dtype_code(name, A)
    if path is not None:
        _known(name, path, LU_PATHS, "elimination path")
    _check(name, A.dtype, A, rhs)
    _same_device(name, A, rhs)
    b, f = _square(name, A)
    if rhs.shape != (b, f):
        raise ValueError(f"{name}: rhs of shape {tuple(rhs.shape)}, want ({b}, {f})")
    lib = _build.load()
    path = _pick_lu_path(name, path, f, A, lib, True)
    if path != "staged":
        _substitution_fits(name, f, A.element_size() + 4, lib, A.device)  # x, int32 perm
    scratch = torch.empty_like(A) if path != "staged" else None
    perm = torch.empty((b, f), dtype=torch.int32, device=A.device) if path == "wide" else None
    x = torch.empty_like(rhs)
    with torch.cuda.device(A.device):
        rc = lib.rt_batched_linsolve(code, LU_PATHS[path], A.data_ptr(), rhs.data_ptr(),
                                     None if scratch is None else scratch.data_ptr(),
                                     None if perm is None else perm.data_ptr(), x.data_ptr(),
                                     b, f, _stream(A.device))
    _raise_on(name, rc)
    launches[name] += 1
    body_launches[name][path] += 1
    return x


def panel_smem_bytes(f, itemsize):
    """Shared memory of ``fused_newton_iter``'s panel body at width ``f``
    (``panel_smem_bytes`` of ``csrc/linalg_common.cuh``): the ring's
    mbarriers and tiles, then the f-entry vector rounded up to 16 bytes."""
    stages = PANEL_STAGES[itemsize]
    tile = PANEL * (PANEL + 16 // itemsize) * itemsize
    return 16 * stages + stages * tile + -(-f * itemsize // 16) * 16


def column_smem_bytes(f, itemsize):
    """Shared memory of the column body: its two f-entry vectors."""
    return 2 * f * itemsize


_NEWTON_SMEM = {"panel": panel_smem_bytes, "column": column_smem_bytes}


def newton_iter_body(f, itemsize, smem_limit):
    """The body of ``fused_newton_iter`` at width ``f``: ``"warp"`` up to
    ``WARP_MAX_F``, else ``"panel"`` where its shared memory fits
    ``smem_limit`` bytes, else ``"column"`` (which ``check_newton_iter_body``
    refuses where it does not fit either)."""
    if f <= WARP_MAX_F:
        return "warp"
    return "panel" if panel_smem_bytes(f, itemsize) <= smem_limit else "column"


def check_newton_iter_body(name, body, f, itemsize, smem_limit):
    """Raise ValueError where the C entry would refuse ``body`` at width
    ``f``: an unknown body, the warp body above ``WARP_MAX_F``, or dynamic
    shared memory above ``smem_limit`` bytes (the warp body's is static)."""
    _known(name, body, NEWTON_BODIES, "body")
    if body == "warp":
        if f > WARP_MAX_F:
            raise ValueError(f"{name}: the warp body takes f <= {WARP_MAX_F}, got f = {f}")
        return
    need = _NEWTON_SMEM[body](f, itemsize)
    if need > smem_limit:
        raise ValueError(f"{name}: the {body} body needs {need} bytes of shared memory at "
                         f"f = {f}, above the device's limit of {smem_limit} bytes")


def fused_newton_iter(lu, perm, k, fk, active, scale, *, body=None):
    """CUDA ``fused_newton_iter``: one chord-Newton iteration against the
    factors of ``batched_lu_factor`` -- residual, permutation gather, the two
    substitutions, the masked commit and the scaled-RMS norm (see
    ``ref.fused_newton_iter``).  ``body`` overrides ``newton_iter_body``'s
    choice (both give the same bits).  Returns new tensors ``(k_new,
    res_norm)``."""
    name = "fused_newton_iter"
    code = _dtype_code(name, k)
    if body is not None:
        _known(name, body, NEWTON_BODIES, "body")
    _check(name, k.dtype, lu, k, fk)
    _check(name, torch.int32, perm)
    _check(name, torch.bool, active)
    _same_device(name, lu, perm, k, fk, active)
    b, f = _square(name, lu)
    if k.shape != (b, f) or fk.shape != (b, f) or perm.shape != (b, f) or active.shape != (b,):
        raise ValueError(f"{name}: shapes lu {tuple(lu.shape)}, perm {tuple(perm.shape)}, k "
                         f"{tuple(k.shape)}, fk {tuple(fk.shape)}, active "
                         f"{tuple(active.shape)} do not agree")
    scale = _row_scale(name, scale, b, f, k)
    _check(name, k.dtype, scale)
    lib = _build.load()
    limit = _smem_limit(name, lib, k.device)
    if body is None:
        body = newton_iter_body(f, k.element_size(), limit)
    check_newton_iter_body(name, body, f, k.element_size(), limit)
    k_new = torch.empty_like(k)
    res = torch.empty((b,), dtype=k.dtype, device=k.device)
    with torch.cuda.device(k.device):
        rc = lib.rt_fused_newton_iter(code, NEWTON_BODIES[body], *(x.data_ptr() for x in (
            lu, perm, k, fk, active, scale, k_new, res)), b, f, _stream(k.device))
    _raise_on(name, rc)
    launches[name] += 1
    body_launches[name][body] += 1
    return k_new, res


def masked_newton_update(k, delta, active, scale):
    """CUDA ``masked_newton_update``: ``k - delta`` where the row is active
    and the (b,) RMS of ``delta / scale``, with the row norm of
    ``fused_newton_iter`` (see ``ref.masked_newton_update``).  Returns new
    tensors ``(k_new, res_norm)``."""
    name = "masked_newton_update"
    code = _dtype_code(name, k)
    _check(name, k.dtype, k, delta)
    _check(name, torch.bool, active)
    _same_device(name, k, delta, active)
    if k.ndim != 2 or delta.shape != k.shape or active.shape != (k.shape[0],) or k.numel() == 0:
        raise ValueError(f"{name}: shapes k {tuple(k.shape)}, delta {tuple(delta.shape)}, "
                         f"active {tuple(active.shape)} do not agree")
    b, f = k.shape
    scale = _row_scale(name, scale, b, f, k)
    _check(name, k.dtype, scale)
    k_new = torch.empty_like(k)
    res = torch.empty((b,), dtype=k.dtype, device=k.device)
    lib = _build.load()
    with torch.cuda.device(k.device):
        rc = lib.rt_masked_newton_update(code, *(x.data_ptr() for x in (
            k, delta, active, scale, k_new, res)), b, f, _stream(k.device))
    _raise_on(name, rc)
    launches[name] += 1
    return k_new, res


_ATTN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_body(hd, dtype):
    """The attention body for head dim ``hd`` and ``dtype``: ``"wgmma"``
    (tensor cores, TMA-fed) for bfloat16 with hd <= 128, else ``"ffma"``."""
    return "wgmma" if dtype == torch.bfloat16 and hd <= 128 else "ffma"


def check_flash_body(body, hd, dtype):
    """Raise ValueError where the C entry would refuse ``body``: an unknown
    body, or wgmma outside bfloat16 with hd <= 128.  FFMA takes every shape
    the wrapper takes."""
    name = "flash_attention_fwd"
    _known(name, body, FLASH_BODIES, "body")
    if body == "wgmma" and (dtype != torch.bfloat16 or hd > 128):
        raise ValueError(f"{name}: the wgmma body takes bfloat16 with hd <= 128, got {dtype} "
                         f"with hd = {hd}")


def flash_attention_fwd(q, k, v, *, causal=True, q_offset=0, body=None):
    """CUDA ``flash_attention_fwd``: GQA attention of q (b, sq, H, hd) over
    k, v (b, sk, KV, hd), query head h on KV head h // (H // KV), ``q_offset``
    the position of q[:, 0] against k[:, 0] (see ``ref.flash_attention_fwd``).
    Ragged lengths need no padding: the kernel masks rows and keys past the
    ends.  ``body`` overrides ``flash_body``'s choice.  Returns a new (b, sq,
    H, hd) tensor in q's dtype."""
    name = "flash_attention_fwd"
    if not isinstance(q, torch.Tensor) or q.dtype not in _ATTN_DTYPES:
        raise TypeError(f"{name}: the CUDA kernel takes float32 or bfloat16, got "
                        f"{getattr(q, 'dtype', type(q).__name__)}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} are not (b, sq, H, hd), (b, sk, KV, hd) twice")
    b, sq, H, hd = q.shape
    body = flash_body(hd, q.dtype) if body is None else body
    check_flash_body(body, hd, q.dtype)
    _check(name, q.dtype, q, k, v)
    _same_device(name, q, k, v)
    sk, KV = k.shape[1], k.shape[2]
    if min(b, sq, sk, H, KV) < 1 or H % KV:
        raise ValueError(f"{name}: {H} query heads over {KV} KV heads, b = {b}, sq = {sq}, "
                         f"sk = {sk}: want non-empty shapes and H % KV == 0")
    if hd % 8 or not 8 <= hd <= 256:
        raise ValueError(f"{name}: head dim {hd} is not a multiple of 8 in [8, 256]")
    q_offset = int(q_offset)
    if q_offset < 0:
        raise ValueError(f"{name}: q_offset {q_offset} < 0")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: the CUDA kernel takes 16-byte aligned tensors")
    out = torch.empty_like(q)
    lib = _build.load()
    with torch.cuda.device(q.device):
        rc = lib.rt_flash_attention_fwd(_ATTN_DTYPES[q.dtype], FLASH_BODIES[body], q.data_ptr(),
                                        k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk, H,
                                        KV, hd, int(bool(causal)), q_offset, _stream(q.device))
    _raise_on(name, rc)
    launches[name] += 1
    body_launches[name][body] += 1
    return out
