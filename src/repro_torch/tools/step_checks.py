"""The rule that holds the fused step kernels (``cuda_impl.fused_step`` and
``cuda_impl.fused_step_poly``) against their plain versions on the card, and
the inputs it is held on.  ``chip_smoke.py`` and
``tests/test_torch_kernels_card.py`` both use it.

Two checks per case:

- ``hold_to_plain``: against ``ref.fused_step`` / ``ref.fused_step_poly`` on
  the same card tensors.  The error estimate ``h * (b_err . K)`` cancels
  (``sum_j b_err_j = 0``), so the two versions round it apart by up to its
  rounding floor

      floor = 4 s eps RMS(|h| sum_j |b_err_j K_j| / scale)   per row,

  which for a smooth polynomial can be most of the estimate.  So
  ``err_ratio`` is held to ``tol |ratio| + 2 floor``, the outputs made from it
  (``dt_out``, ``new_inv``) to a relative ``tol + 2 floor / ratio``, and a
  decision may differ only where ``|ratio - 1| <= max(KNIFE_EDGE, 2 floor)``
  (such rows are counted, and left out of the outputs that follow the
  decision).  Every other output -- ``y1``, ``y_out``, ``f_out``, ``t_out``,
  ``new_inv2`` and the coefficients -- goes through
  ``torch.testing.assert_close`` at ``state_tol`` (default ``tol``).
- ``bitwise_mismatches``: against the unfused card path (``unfused_card``),
  element for element; the kernels are built to agree with it exactly.
"""

from __future__ import annotations

from unittest import mock

import numpy as np
import torch

from ..kernels import cuda_impl, ref

# fused_step's outputs, in order; the tenth is the coefficient tuple or None.
STEP_OUTS = ("y1", "err_ratio", "accept", "y_out", "f_out", "t_out", "dt_out", "new_inv",
             "new_inv2")
COEFF_OUTS = ("c0", "c1", "c2", "c3")
KNIFE_EDGE = 1e-4  # |err_ratio - 1| below which two roundings may decide apart
# float32 fused_step_poly's state outputs: its stages are a chain of Horner
# evaluations that the two versions round apart (tests/test_fused_step.py
# holds the Pallas kernel to the JAX plain op at the same 2e-4).
POLY32_STATE = 2e-4


def tolerance(dtype) -> float:
    """fma contraction and summation order only."""
    return 1e-5 if dtype == torch.float32 else 1e-12


def step_inputs(b, f, s, dtype, device, generator, dt_scale=1.0):
    """Random inputs of one step attempt, made on the CPU from ``generator``:
    ``(y, K, cols, failed)`` with ``cols = (t, t_new, dt_cur, safe_dt,
    running, prev_inv, prev2_inv)``; about a quarter of the rows are not
    running and a tenth have ``failed`` set."""
    def u(lo, hi, *shape):
        return (lo + (hi - lo) * torch.rand(*shape, generator=generator, dtype=dtype)).to(device)

    y, t, dt_cur = u(0.5, 1.5, b, f), u(0.0, 1.0, b), dt_scale * u(0.05, 0.2, b)
    safe_dt = 0.9 * dt_cur
    cols = (t, t + safe_dt, dt_cur, safe_dt,
            (torch.rand(b, generator=generator) > 0.25).to(device),
            u(0.5, 2.0, b), u(0.5, 2.0, b))
    K = torch.randn(s, b, f, generator=generator, dtype=dtype).to(device)
    failed = (torch.rand(b, generator=generator) < 0.1).to(device)
    return y, K, cols, failed


def ratio_floor(y, y1, K, h, b_err, atol, rtol):
    """The per-row rounding floor of ``err_ratio`` (see the module doc)."""
    w = torch.as_tensor(np.abs(np.asarray(b_err, dtype=np.float64)), dtype=y.dtype,
                        device=y.device)
    comb = h.abs()[:, None] * torch.tensordot(w, K.abs(), dims=1)
    at, rt = ref.broadcast_tolerances(atol, rtol, y.dtype, y.device)
    scale = at + rt * torch.maximum(y.abs(), y1.abs())
    eps = torch.finfo(y.dtype).eps
    return 4 * K.shape[0] * eps * ((comb / scale) ** 2).mean(dim=-1).sqrt()


def unfused_card(fn):
    """``fn`` (a plain fused step) with the unfused path's three kernels in
    place of their plain ops: what the unfused step computes on the card."""
    with mock.patch.multiple(ref, stage_accum=cuda_impl.stage_accum,
                             fused_update=cuda_impl.fused_update,
                             error_norm=cuda_impl.error_norm):
        return fn()


def _named(out):
    pairs = list(zip(STEP_OUTS, out[:9]))
    return pairs + list(zip(COEFF_OUTS, out[9] or ()))


def bitwise_mismatches(got, want) -> dict:
    """Elements that differ bitwise (NaN equal to NaN), per output name."""
    if (got[9] is None) != (want[9] is None):
        return {"coeffs": "present in one only"}
    out = {}
    for (k, g), (_, w) in zip(_named(got), _named(want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            out[k] = f"{tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} {w.dtype}"
            continue
        n = int((~((g == w) | ((g != g) & (w != w)))).sum())
        if n:
            out[k] = n
    return out


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def hold_to_plain(name, got, want, floor, state_tol=None):
    """Hold a kernel's outputs ``got`` against the plain version's ``want``
    (see the module doc); raises ``AssertionError`` naming the output.
    Returns ``(max_abs_err, max_rel_err, knife_edge_rows)``, the errors over
    ``err_ratio`` and the outputs held to a fixed tolerance.  ``dt_out`` and
    ``new_inv`` are left out of them: on a row whose error estimate is
    rounding noise their rule allows a large part of their size."""
    tol = tolerance(want[0].dtype)
    state = state_tol or tol
    ratio = want[1]
    finite = torch.isfinite(ratio)
    _check(torch.equal(torch.isfinite(got[1]), finite),
           f"{name}/err_ratio: finite on other rows than the plain version")
    ratio_diff = (got[1] - ratio).abs()[finite]
    _check(bool((ratio_diff <= (tol * ratio.abs() + 2 * floor + tol)[finite]).all()),
           f"{name}/err_ratio: beyond tol |ratio| + 2 floor")
    differ = got[2] != want[2]
    edge = (ratio - 1.0).abs() <= torch.clamp(2 * floor, min=KNIFE_EDGE)
    _check(bool((~differ | edge).all()), f"{name}/accept: differs away from err_ratio = 1")
    _check((got[9] is None) == (want[9] is None), f"{name}: coefficients in one output only")
    keep = ~differ
    rel = tol + torch.where(floor > 0, 2 * floor / torch.where(finite, ratio.abs(), 1.0), 0.0)
    worst = float(ratio_diff.max()) if finite.any() else 0.0
    scale = float(ratio[finite].abs().max()) if finite.any() else 0.0
    for (k, g), (_, w) in zip(_named(got), _named(want)):
        if k in ("err_ratio", "accept"):
            continue
        r = rel
        if k not in ("y1",) + COEFF_OUTS:  # outputs that follow the decision
            g, w, r = g[keep], w[keep], rel[keep]
        if k in ("dt_out", "new_inv"):
            _check(bool(((g - w).abs() <= r * w.abs() + tol).all()),
                   f"{name}/{k}: beyond tol + 2 floor / ratio")
            continue
        torch.testing.assert_close(g, w, rtol=state, atol=tol,
                                   msg=lambda m, k=k: f"{name}/{k}: {m}")
        fin = torch.isfinite(w)
        if fin.any():
            worst = max(worst, float((g[fin] - w[fin]).abs().max()))
            scale = max(scale, float(w[fin].abs().max()))
    return worst, worst / max(scale, 1e-300), int((differ & edge).sum())
