"""Plain PyTorch versions of the solver's hot-spot ops.

Each function mirrors the op of the same name in the JAX package's
``kernels/ref.py`` expression for expression.  They are the semantics the CUDA
kernels in ``csrc/solver_kernels.cu`` must match, and the execution path for
tensors that lie on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def _weights(c, like):
    """Tableau weights (numpy or tensor) as a tensor in ``like``'s dtype and
    device, as the JAX ref casts them to the stages' dtype."""
    if isinstance(c, torch.Tensor):
        return c.to(dtype=like.dtype, device=like.device)
    return torch.tensor(np.ascontiguousarray(c), dtype=like.dtype, device=like.device)


def stage_accum(y, dt, K, coeffs):
    """y + dt * sum_j coeffs[j] * K[j].

    y:      (b, f)
    dt:     (b,)
    K:      (j, b, f)  -- stacked stage derivatives
    coeffs: (j,)       -- tableau row a[i, :j]
    """
    acc = torch.tensordot(_weights(coeffs, K), K, dims=1)
    return y + dt[:, None] * acc


def fused_update(y, K, dt, b_sol, b_err):
    """One fused pass producing the solution update and the embedded error.

    y1  = y + dt * (b_sol . K)
    err =     dt * (b_err . K)

    K: (s, b, f); b_sol, b_err: (s,).  Returns (y1, err), both (b, f).
    """
    b_sol, b_err = _weights(b_sol, K), _weights(b_err, K)
    y1 = y + dt[:, None] * torch.tensordot(b_sol, K, dims=1)
    err = dt[:, None] * torch.tensordot(b_err, K, dims=1)
    return y1, err


def broadcast_tolerances(atol, rtol, dtype, device=None):
    """Normalize tolerances onto column-broadcastable tensors.

    Accepted shapes: scalar (batch-shared), (b,) per-instance, or full (b, f).
    Returns (atol, rtol) ready to broadcast against a (b, f) state.
    ``device`` places Python scalars; tensors keep the device they are on.
    """
    atol = torch.as_tensor(atol, dtype=dtype, device=device)
    rtol = torch.as_tensor(rtol, dtype=dtype, device=device)
    if atol.ndim == 1:
        atol = atol[:, None]
    if rtol.ndim == 1:
        rtol = rtol[:, None]
    return atol, rtol


def error_norm(err, y0, y1, atol, rtol):
    """Weighted RMS norm, per instance.

    ||err / (atol + rtol * max(|y0|, |y1|))||_rms  over the feature axis.

    err, y0, y1: (b, f);  atol, rtol: scalar or (b,) or (b, f).
    Returns (b,).
    """
    atol, rtol = broadcast_tolerances(atol, rtol, err.dtype, err.device)
    scale = atol + rtol * torch.maximum(torch.abs(y0), torch.abs(y1))
    ratio = err / scale
    return torch.sqrt(torch.mean(ratio * ratio, dim=-1))


def rms_norm(x, scale):
    """Scaled RMS over the feature axis: ||x / scale||_rms.

    x, scale: (b, f) (scale may broadcast).  Returns (b,).
    """
    ratio = x / scale
    return torch.sqrt(torch.mean(ratio * ratio, dim=-1))


def hermite_coeffs(y0, y1, f0, f1, dt):
    """Cubic-Hermite dense-output coefficients in Horner form.

    p(x) = ((c3 * x + c2) * x + c1) * x + c0,  x = (t - t0)/dt in [0, 1].
    Returns (c0, c1, c2, c3), each (b, f).
    """
    hdt = dt[:, None]
    c0 = y0
    c1 = hdt * f0
    c2 = 3.0 * (y1 - y0) - hdt * (2.0 * f0 + f1)
    c3 = 2.0 * (y0 - y1) + hdt * (f0 + f1)
    return c0, c1, c2, c3


def pid_update(
    err_ratio, dt, prev_inv, prev2_inv,
    *, b1, b2, b3, safety, factor_min, factor_max, dt_min, dt_max,
):
    """The Soederlind digital-filter step update behind ``PIDController``.

    err_ratio: (b,) weighted RMS error ratio of this step
    dt:        (b,) step size just attempted (signed)
    prev_inv / prev2_inv: (b,) inverse error ratios of the last two accepts
    b1/b2/b3:  Soederlind exponents (already divided by the controller order)

    Returns ``(accept, dt_next, new_inv, new_inv2)``.
    """
    dtype = dt.dtype
    # Guard: err_ratio == 0 (exact solve) -> use factor_max.
    finite = torch.isfinite(err_ratio)
    safe_ratio = torch.where(finite & (err_ratio > 0.0), err_ratio, 1.0)
    inv = 1.0 / safe_ratio

    factor = safety * inv**b1 * prev_inv**b2 * prev2_inv**b3
    factor = torch.where(err_ratio == 0.0, factor_max, factor)
    # Non-finite error estimate: treat as a hard reject, halve the step.
    factor = torch.where(finite, factor, 0.5)
    factor = torch.clamp(factor, factor_min, factor_max)

    accept = finite & (err_ratio <= 1.0)
    # On rejection never grow the step.
    factor = torch.where(accept, factor, torch.clamp(factor, max=1.0))

    mag = torch.clamp(torch.abs(dt) * factor.to(dtype), dt_min, dt_max)
    dt_next = torch.sign(dt) * mag

    # Error history advances only on accepted steps (torchode semantics).
    new_inv = torch.where(accept, inv, prev_inv)
    new_inv2 = torch.where(accept, prev_inv, prev2_inv)
    return accept, dt_next, new_inv, new_inv2


def interp_eval(coeffs, x, mask, out):
    """Masked Horner evaluation of the dense-output polynomial.

    coeffs: tuple of (b, f) tensors, low -> high degree
    x:      (b, n) normalized evaluation positions
    mask:   (b, n) bool -- which (instance, point) cells to write this step
    out:    (b, n, f) existing output buffer

    Returns updated (b, n, f) buffer: where mask, p(x); elsewhere out.
    """
    xe = x[:, :, None]
    acc = coeffs[-1][:, None, :].expand(xe.shape[:2] + coeffs[-1].shape[-1:])
    for c in coeffs[-2::-1]:
        acc = acc * xe + c[:, None, :]
    return torch.where(mask[:, :, None], acc, out)


def interp_eval_window(coeffs, x, mask, out, cursor):
    """``interp_eval`` on a window of W eval points per row, starting at the
    per-row ``cursor``: gather the (b, W, f) window of ``out``, merge, and
    scatter it back (the windowed dense-output write of the JAX ``step.py``).

    x, mask: (b, W); out: (b, n, f); cursor: (b,) int64 with cursor <= n - W.
    Returns the updated (b, n, f) buffer.
    """
    W = x.shape[1]
    idx = (cursor[:, None] + torch.arange(W, device=cursor.device))[:, :, None]
    idx = idx.expand(-1, -1, out.shape[-1])
    merged = interp_eval(coeffs, x, mask, torch.gather(out, 1, idx))
    return out.scatter(1, idx, merged)
