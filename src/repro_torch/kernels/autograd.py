"""Reverse-mode rules for the four explicit-path CUDA kernels.

One ``torch.autograd.Function`` each for ``stage_accum``, ``fused_update``,
``error_norm`` and ``interp_eval``.  The forward launches the CUDA kernel
through ``cuda_impl`` (grad mode is off inside ``Function.forward``, so the
wrapper's refusal of inputs that require grad does not fire); the backward
is plain torch and returns what ``torch.autograd.grad`` of the plain op in
``ref.py`` returns, term for term in autograd's own order: the same
formulas, the same ties (``maximum`` splits a tie in halves, ``abs'(0) =
0``) and the same non-finite values (a row whose error ratio is 0 gets
``0 * inf``, NaN, as autograd of the plain op gives it).  The backward calls
no op of ``ref.py``, so it never gives way to the plain forward.

``ops`` sends a CUDA call here when grad mode is on and an input requires
grad; the JAX package has no backward Pallas kernel to port, and its
``ScanAdjoint`` differentiates these same plain expressions.

Saved stages: the explicit stepper writes its stages into one (s, b, f)
buffer and hands ``stage_accum`` the prefix ``K[:i]`` before it writes
``K[i]``.  The prefix never changes after the call, but it shares the
buffer's version counter, so the Functions save ``_frozen(K)``: the same
memory under a counter of its own.  Saved tensors go through
``save_for_backward``, so ``torch.utils.checkpoint`` drops and recomputes
them like any other.

``interp_eval`` writes the dense output in place on the card.  Under
autograd the Function writes into a copy of ``out`` instead, so no tensor
autograd may have saved, and no input of a checkpointed block that is
recomputed later, is changed.  Without grad the in-place contract of
``core/step.py`` stays.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import cuda_impl


def _frozen(t):
    """``t``'s memory, shape and strides under a version counter of its own
    (see the module docstring).  Only inside ``Function.forward``."""
    return torch.empty(0, dtype=t.dtype, device=t.device).set_(
        t.untyped_storage(), t.storage_offset(), t.size(), t.stride())


@functools.lru_cache(maxsize=256)
def _cached_weights(values, dtype, device):
    return torch.tensor(values, dtype=dtype, device=device)


def _weights(coeffs, like):
    """Tableau weights as a tensor in ``like``'s dtype and device, as
    ``ref._weights`` makes them; each row is copied to the device once, not
    once per backward (a copy from host memory waits for the device)."""
    if isinstance(coeffs, torch.Tensor):
        return coeffs.to(dtype=like.dtype, device=like.device)
    values = tuple(np.asarray(coeffs, dtype=np.float64).reshape(-1).tolist())
    return _cached_weights(values, like.dtype, like.device)


def _sum_to(grad, tol):
    """The gradient of a broadcast tolerance, summed back to its shape:
    a scalar, (b,) (broadcast as (b, 1)) or (b, f)."""
    if tol.ndim == 1:
        return grad.sum_to_size(tol.shape[0], 1).reshape(tol.shape)
    return grad.sum_to_size(tol.shape)


class StageAccum(torch.autograd.Function):
    """``y + dt[:, None] * sum_j coeffs[j] * K[j]``; ``coeffs`` are tableau
    constants, not differentiated."""

    @staticmethod
    def forward(ctx, y, dt, K, coeffs):
        out = cuda_impl.stage_accum(y, dt, K, coeffs)
        ctx.coeffs = coeffs
        ctx.save_for_backward(dt, _frozen(K))
        return out

    @staticmethod
    def backward(ctx, g):
        dt, K = ctx.saved_tensors
        need_y, need_dt, need_K, _ = ctx.needs_input_grad
        w = _weights(ctx.coeffs, K)
        gdt = gK = None
        if need_dt:
            gdt = (g * torch.tensordot(w, K, dims=1)).sum(-1)
        if need_K:
            gK = w[:, None, None] * (g * dt[:, None])
        return (g if need_y else None), gdt, gK, None


class FusedUpdate(torch.autograd.Function):
    """``(y + dt * (b_sol . K), dt * (b_err . K))``."""

    @staticmethod
    def forward(ctx, y, K, dt, b_sol, b_err):
        y1, err = cuda_impl.fused_update(y, K, dt, b_sol, b_err)
        ctx.weights = (b_sol, b_err)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(dt, _frozen(K))
        return y1, err

    @staticmethod
    def backward(ctx, g1, ge):
        dt, K = ctx.saved_tensors
        need_y, need_K, need_dt, _, _ = ctx.needs_input_grad
        # Autograd reaches the err product first (it was recorded last).
        parts = [(gr, _weights(w, K)) for gr, w in ((ge, ctx.weights[1]), (g1, ctx.weights[0]))
                 if gr is not None]
        gdt = gK = None
        if need_dt:
            for gr, w in parts:
                term = (gr * torch.tensordot(w, K, dims=1)).sum(-1)
                gdt = term if gdt is None else gdt + term
        if need_K:
            for gr, w in parts:
                term = w[:, None, None] * (gr * dt[:, None])
                gK = term if gK is None else gK + term
        return (g1 if need_y else None), gK, gdt, None, None


class ErrorNorm(torch.autograd.Function):
    """``sqrt(mean((err / (atol + rtol * max(|y0|, |y1|)))**2, -1))``."""

    @staticmethod
    def forward(ctx, err, y0, y1, atol, rtol):
        out = cuda_impl.error_norm(err, y0, y1, atol, rtol)
        tols = [t for t in (atol, rtol) if isinstance(t, torch.Tensor)]
        ctx.tols = tuple(None if isinstance(t, torch.Tensor) else t for t in (atol, rtol))
        ctx.save_for_backward(err, y0, y1, out, *tols)
        return out

    @staticmethod
    def backward(ctx, g):
        err, y0, y1, out, *tols = ctx.saved_tensors
        tols = iter(tols)
        atol, rtol = (next(tols) if t is None else t for t in ctx.tols)
        need_err, need_y0, need_y1, need_atol, need_rtol = ctx.needs_input_grad
        # A scalar tolerance stays a number: as a tensor on the card it would
        # be a copy from host memory, which waits for the device.
        atol_b, rtol_b = (t[:, None] if isinstance(t, torch.Tensor) and t.ndim == 1 else t
                          for t in (atol, rtol))
        a0, a1 = torch.abs(y0), torch.abs(y1)
        m = torch.maximum(a0, a1)
        scale = atol_b + rtol_b * m
        ratio = err / scale
        # sqrt, mean over the features, ratio * ratio (both factors the same
        # tensor: two equal terms), then the quotient.
        gq = (g / (2 * out))[:, None].expand(err.shape) / err.shape[-1]
        gratio = gq * ratio + gq * ratio
        gerr = gratio / scale if need_err else None
        gy0 = gy1 = gatol = grtol = None
        if need_y0 or need_y1 or need_atol or need_rtol:
            gscale = -gratio * ((err / scale) / scale)
            if need_atol:
                gatol = _sum_to(gscale, atol)
            if need_rtol:
                grtol = _sum_to(gscale * m, rtol)
            gm = gscale * rtol_b
            tie = torch.where(a0 == a1, gm / 2, gm)
            if need_y0:
                gy0 = tie.masked_fill(a0 < a1, 0) * torch.sgn(y0)
            if need_y1:
                gy1 = tie.masked_fill(a0 > a1, 0) * torch.sgn(y1)
        return gerr, gy0, gy1, gatol, grtol


class InterpEval(torch.autograd.Function):
    """The masked Horner write ``where(mask, p(x), out)`` (with ``cursor``,
    on the (b, W) window at each row's cursor).  Writes into a copy of
    ``out``; the coefficients come last, as varargs."""

    @staticmethod
    def forward(ctx, x, mask, out, cursor, *coeffs):
        res = cuda_impl.interp_eval(coeffs, x, mask, out.clone(), cursor)
        ctx.windowed = cursor is not None
        ctx.save_for_backward(x, mask, *coeffs, *((cursor,) if ctx.windowed else ()))
        return res

    @staticmethod
    def backward(ctx, g):
        x, mask, *coeffs = ctx.saved_tensors
        cursor = coeffs.pop() if ctx.windowed else None
        need_x, _, need_out, _, *need_c = ctx.needs_input_grad
        f = g.shape[-1]
        gw = g
        if cursor is not None:
            idx = cursor[:, None] + torch.arange(x.shape[1], device=cursor.device)
            idx = idx[:, :, None].expand(-1, -1, f)
            gw = torch.gather(g, 1, idx)
        m3 = mask[:, :, None]
        gout = None
        if need_out:
            if cursor is None:
                gout = torch.where(m3, 0.0, g)
            else:
                gout = g.scatter(1, idx, torch.where(m3, 0.0, gw))
        # Horner's partial sums acc_k = acc_{k+1} * x + c_k, from the top
        # coefficient down; walked back from acc_0, whose gradient is the
        # masked one.
        xe = x[:, :, None]
        top = coeffs[-1][:, None, :].expand(gw.shape)
        partial = [top]
        for c in coeffs[-2:0:-1]:
            partial.append(partial[-1] * xe + c[:, None, :])
        ga = torch.where(m3, gw, 0.0)
        gc = [None] * len(coeffs)
        gx = None
        for k in range(len(coeffs) - 1):
            if need_c[k]:
                gc[k] = ga.sum(dim=1)
            if need_x:
                term = (ga * partial[-1 - k]).sum(dim=-1, keepdim=True)
                gx = term if gx is None else gx + term
            ga = ga * xe
        if need_c[-1]:
            gc[-1] = ga.sum(dim=1)
        return (gx[:, :, 0] if gx is not None else None), None, gout, None, *gc


def stage_accum(y, dt, K, coeffs):
    return StageAccum.apply(y, dt, K, coeffs)


def fused_update(y, K, dt, b_sol, b_err):
    return FusedUpdate.apply(y, K, dt, b_sol, b_err)


def error_norm(err, y0, y1, atol, rtol):
    return ErrorNorm.apply(err, y0, y1, atol, rtol)


def interp_eval(coeffs, x, mask, out, cursor=None):
    return InterpEval.apply(x, mask, out, cursor, *coeffs)
