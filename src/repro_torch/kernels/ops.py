"""Dispatch layer over the solver's hot-spot ops, by the device of the data.

The op names are the JAX package's registry names (``kernels/ops.py`` there).
There is no backend switch: a tensor that lies on the CPU goes to the plain
version in ``ref.py``; a CUDA tensor goes to the hand-written CUDA kernel in
``cuda_impl.py``, or the call raises.  Nothing gives way to the plain version
on the card.  ``launches`` counts the CUDA launches of each kernel.

Gradients: on a CUDA tensor, with grad mode on and an input that requires
grad, every solver op goes through its ``torch.autograd.Function`` in
``autograd.py`` (the kernel forward, a plain-torch backward), and the
attention through ``FlashAttention`` (the CUDA forward and backward).  So
does forward mode: an input that carries a tangent (a
``torch.autograd.forward_ad`` dual tensor, a ``torch.func.jvp`` wrapper)
takes the Function, whose ``jvp`` launches the kernel again on the
tangents where the op is linear in them; a raw ``cuda_impl`` wrapper
refuses such an input rather than drop its tangent.  Without a dual level
or a transform the test costs two reads of global state.  CPU tensors take
the plain ops and their own autograd; the attention there takes
``FlashAttention`` too, with the plain forward and backward (it has no
``jvp`` yet).

The solver core (``core/stepper.py`` for the stage math, ``core/newton.py``
for the chord-Newton linear algebra, ``core/step.py`` for the error norm, the
fused step and dense-output writes, ``core/events.py`` for event detection,
localization and commit) imports its ops only from here, as does the LM's
attention (``models/attention.py``, ``flash_attention_fwd``).  They refuse
a DTensor: under a mesh each rank passes its local shards.
"""

from __future__ import annotations

import torch
import torch.utils._pytree as pytree
from torch.distributed.tensor import DTensor

from . import autograd, cuda_impl, ref

launches = cuda_impl.launches


def _on_cuda(name, t):
    if isinstance(t, DTensor):
        # a DTensor's device is its local shard's: the kernels take the
        # local shards (models/attention.py runs them through local_map)
        raise TypeError(f"{name}: got a DTensor; pass each rank's local shard")
    kind = t.device.type
    if kind == "cpu":
        return False
    if kind == "cuda":
        return True
    raise ValueError(f"{name}: no implementation for tensors on {t.device}")


def _taped(*tensors):
    """Whether this call goes through the autograd Function: autograd
    records it (grad mode is on and a tensor input requires grad), or an
    input carries a forward-mode tangent or is a ``torch.func`` wrapper
    (``cuda_impl.transformed``; only looked at in forward mode)."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        return True
    return cuda_impl.forward_mode() and any(cuda_impl.transformed(t) for t in tensors)


def carries_tangent(tree) -> bool:
    """Whether a leaf of ``tree`` carries a forward-mode tangent or is a
    ``torch.func`` wrapper (``cuda_impl.transformed``): what a captured
    graph, a packed buffer or a raw kernel would drop."""
    return cuda_impl.forward_mode() and any(
        cuda_impl.transformed(x) for x in pytree.tree_leaves(tree))


def stage_accum(y, dt, K, coeffs):
    if _on_cuda("stage_accum", y):
        if _taped(y, dt, K):
            return autograd.stage_accum(y, dt, K, coeffs)
        return cuda_impl.stage_accum(y, dt, K, coeffs)
    return ref.stage_accum(y, dt, K, coeffs)


def fused_update(y, K, dt, b_sol, b_err):
    if _on_cuda("fused_update", y):
        if _taped(y, K, dt):
            return autograd.fused_update(y, K, dt, b_sol, b_err)
        return cuda_impl.fused_update(y, K, dt, b_sol, b_err)
    return ref.fused_update(y, K, dt, b_sol, b_err)


def error_norm(err, y0, y1, atol, rtol):
    if _on_cuda("error_norm", err):
        if _taped(err, y0, y1, atol, rtol):
            return autograd.error_norm(err, y0, y1, atol, rtol)
        return cuda_impl.error_norm(err, y0, y1, atol, rtol)
    return ref.error_norm(err, y0, y1, atol, rtol)


def interp_eval(coeffs, x, mask, out, cursor=None):
    """Masked dense-output write.  Returns the updated (b, n, f) buffer; on
    the card the kernel updates ``out`` in place and returns it, so callers
    always use the returned buffer.  With ``cursor``, ``x``/``mask`` are a
    (b, W) window starting at each row's cursor (``ref.interp_eval_window``).
    Under autograd the card writes into a copy of ``out`` instead."""
    if _on_cuda("interp_eval", out):
        if _taped(x, mask, out, cursor, *coeffs):
            return autograd.interp_eval(coeffs, x, mask, out, cursor)
        return cuda_impl.interp_eval(coeffs, x, mask, out, cursor)
    if cursor is None:
        return ref.interp_eval(coeffs, x, mask, out)
    return ref.interp_eval_window(coeffs, x, mask, out, cursor)


def fused_step(y, K, f1, t, t_new, dt_cur, safe_dt, running, prev_inv, prev2_inv,
               atol, rtol, *, b_sol, b_err, ctrl, want_coeffs, ctrl_mode="pid",
               failed=None, f0=None):
    args = (y, K, f1, t, t_new, dt_cur, safe_dt, running, prev_inv, prev2_inv, atol, rtol)
    kw = dict(b_sol=b_sol, b_err=b_err, ctrl=ctrl, want_coeffs=want_coeffs,
              ctrl_mode=ctrl_mode, failed=failed, f0=f0)
    if _on_cuda("fused_step", y):
        if _taped(*args, failed, f0):
            return autograd.fused_step(*args, **kw)
        return cuda_impl.fused_step(*args, **kw)
    return ref.fused_step(*args, **kw)


def fused_step_poly(y, f0, t, t_new, dt_cur, safe_dt, running, prev_inv, prev2_inv,
                    atol, rtol, *, a, c, b_sol, b_err, poly, ctrl, want_coeffs,
                    fsal=True, ctrl_mode="pid"):
    args = (y, f0, t, t_new, dt_cur, safe_dt, running, prev_inv, prev2_inv, atol, rtol)
    kw = dict(a=a, c=c, b_sol=b_sol, b_err=b_err, poly=poly, ctrl=ctrl,
              want_coeffs=want_coeffs, fsal=fsal, ctrl_mode=ctrl_mode)
    if _on_cuda("fused_step_poly", y):
        if _taped(*args):
            return autograd.fused_step_poly(*args, **kw)
        return cuda_impl.fused_step_poly(*args, **kw)
    return ref.fused_step_poly(*args, **kw)


def batched_linsolve(A, rhs):
    if _on_cuda("batched_linsolve", A):
        if _taped(A, rhs):
            return autograd.batched_linsolve(A, rhs)
        return cuda_impl.batched_linsolve(A, rhs)
    return ref.batched_linsolve(A, rhs)


def batched_lu_factor(A):
    if _on_cuda("batched_lu_factor", A):
        if _taped(A):
            return autograd.batched_lu_factor(A)
        return cuda_impl.batched_lu_factor(A)
    return ref.batched_lu_factor(A)


def fused_newton_iter(lu, perm, k, fk, active, scale):
    if _on_cuda("fused_newton_iter", k):
        if _taped(lu, perm, k, fk, active, scale):
            return autograd.fused_newton_iter(lu, perm, k, fk, active, scale)
        return cuda_impl.fused_newton_iter(lu, perm, k, fk, active, scale)
    return ref.fused_newton_iter(lu, perm, k, fk, active, scale)


def masked_newton_update(k, delta, active, scale):
    if _on_cuda("masked_newton_update", k):
        if _taped(k, delta, active, scale):
            return autograd.masked_newton_update(k, delta, active, scale)
        return cuda_impl.masked_newton_update(k, delta, active, scale)
    return ref.masked_newton_update(k, delta, active, scale)


def masked_bisect_refine(coeffs, lo, hi, v_lo, v_mid, active):
    if _on_cuda("masked_bisect_refine", lo):
        if _taped(lo, hi, v_lo, v_mid, active, *coeffs):
            return autograd.masked_bisect_refine(coeffs, lo, hi, v_lo, v_mid, active)
        return cuda_impl.masked_bisect_refine(coeffs, lo, hi, v_lo, v_mid, active)
    return ref.masked_bisect_refine(coeffs, lo, hi, v_lo, v_mid, active)


def fused_event_detect(v_prev, v_new, fired, accept, *, directions):
    if _on_cuda("fused_event_detect", v_prev):
        if _taped(v_prev, v_new, fired, accept):
            return autograd.fused_event_detect(v_prev, v_new, fired, accept, directions=directions)
        return cuda_impl.fused_event_detect(v_prev, v_new, fired, accept, directions=directions)
    return ref.fused_event_detect(v_prev, v_new, fired, accept, directions=directions)


def fused_event_commit(x, y_ev, newly, y_new, t0, dt, fired, ev_t, ev_y, *, terminal):
    """Event-record commit (see ``ref.fused_event_commit``).  On the card the
    kernel updates ``ev_y`` in place and returns it as ``ev_y'``, so callers
    always use the returned buffer.  Under autograd the card writes into a
    copy of ``ev_y`` instead."""
    args = (x, y_ev, newly, y_new, t0, dt, fired, ev_t, ev_y)
    if _on_cuda("fused_event_commit", y_new):
        if _taped(*args):
            return autograd.fused_event_commit(*args, terminal=terminal)
        return cuda_impl.fused_event_commit(*args, terminal=terminal)
    return ref.fused_event_commit(*args, terminal=terminal)


def flash_attention_fwd(q, k, v, *, causal=True, q_offset=0, q_chunk=256, kv_chunk=128):
    """GQA flash attention, forward (see ``ref.flash_attention_fwd``).  On
    the card every shape goes to the kernel, ragged lengths and
    ``q_offset`` included; ``q_chunk``/``kv_chunk`` set only the plain
    version's blocks (the kernel has its own tiles).  Under autograd, on
    either device, through ``autograd.FlashAttention``."""
    on_cuda = _on_cuda("flash_attention_fwd", q)
    if _taped(q, k, v):
        return autograd.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                                        q_chunk=q_chunk, kv_chunk=kv_chunk)
    if on_cuda:
        return cuda_impl.flash_attention_fwd(q, k, v, causal=causal, q_offset=q_offset)
    return ref.flash_attention_fwd(q, k, v, causal=causal, q_offset=q_offset, q_chunk=q_chunk,
                                   kv_chunk=kv_chunk)


for _op in (stage_accum, fused_update, error_norm, fused_step, fused_step_poly,
            batched_linsolve, batched_lu_factor, fused_newton_iter, masked_newton_update,
            masked_bisect_refine, fused_event_detect):
    _op.__doc__ = getattr(ref, _op.__name__).__doc__
del _op

# Plain torch on every device, as they are plain jnp in the JAX package: no
# Pallas kernel exists for them.
hermite_coeffs = ref.hermite_coeffs
rms_norm = ref.rms_norm
broadcast_tolerances = ref.broadcast_tolerances
pid_update = ref.pid_update
poly_eval = ref.poly_eval
