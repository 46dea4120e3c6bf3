"""Reverse- and forward-mode rules for the solver's thirteen CUDA kernels,
and the attention's reverse rule (``FlashAttention``: the CUDA forward and
the CUDA backward).

One ``torch.autograd.Function`` for each: the explicit path's
``stage_accum``, ``fused_update``, ``error_norm`` and ``interp_eval``; the
fused step's ``fused_step`` and ``fused_step_poly``; the event layer's
``masked_bisect_refine``, ``fused_event_detect`` and ``fused_event_commit``;
the stiff path's ``batched_lu_factor``, ``batched_linsolve``,
``fused_newton_iter`` and ``masked_newton_update``.  The forward launches
the CUDA kernel through ``cuda_impl`` (grad mode is off inside
``Function.forward``, so the wrapper's refusal of inputs that require grad
does not fire); the backward is plain torch and returns what
``torch.autograd.grad`` of the plain op in ``ref.py`` returns, term for term
in autograd's own order: the same formulas, the same ties (``maximum``
splits a tie in halves, ``abs'(0) = 0``, ``clamp`` passes the gradient at
its bounds) and the same non-finite values (a row whose error ratio is 0
gets ``0 * inf``, NaN, as autograd of the plain op gives it; a failed row's
ratio is set to inf after the norm, and the norm's backward divides by the
value before).  A cotangent that does not arrive (``None``) adds nothing,
as autograd runs no backward of an operation no gradient reaches.  On the
card no backward calls an op of ``ref.py``, so none gives way to the plain
forward; what the kernel keeps on chip and the formulas need (the
controller's factor, Horner's partial sums, the Newton update) is
recomputed from saved tensors in plain torch.  Bool and int
outputs are non-differentiable; tableau weights, the polynomial, the
controller's parameters and the event flags are static.

``ops`` sends a CUDA call here when grad mode is on and an input requires
grad, or when an input carries a forward-mode tangent; the JAX package has
no backward Pallas kernel to port, and its ``ScanAdjoint`` differentiates
these same plain expressions.

Forward mode.  The thirteen solver Functions take the ``forward`` +
``setup_context`` form that ``torch.func`` needs, and a ``jvp`` that returns
what ``torch.func.jvp`` of the plain op returns, term for term (abs'(0) = 0,
``maximum`` splits a tie in halves, the same non-finite values).  Where the
op is linear in what carries the tangent, the tangent is its own kernel
launched again on the tangents: ``stage_accum`` and ``fused_update`` (on
(0, K'), then on (that, dt', K), plus y' -- summed as the plain op's jvp
sums them, since the error estimate's tangent cancels and magnifies any
other order's rounding), ``interp_eval`` (on the coefficients' tangents
into a copy of out's, then on the derivative polynomial times x'),
``masked_newton_update`` (on (k', delta')) and ``batched_linsolve`` (on rhs'
- A' x, the same A); ``fused_newton_iter`` launches once on every row for
delta' (k = 0, so its k' is -delta' exactly), the factors' tangent term in
plain torch from the triangles split once a factorisation.  The other seven compute their tangents in plain torch from
saved tensors, as their backwards do; no jvp calls an op of ``ref.py``.  A
tangent that does not arrive is None (``set_materialize_grads(False)``),
and an output no tangent reaches gets zeros (``_filled``).  Under
``torch.func.jvp`` the jvp runs one transform level down (``_jvp``), so the
kernels read plain tensors; a second transform around the first is refused.
The fused steps return c0, the input y, as a copy, and write their extra
buffers (error estimate, stages, stage arguments) as outputs marked
non-differentiable, since ``setup_context`` sees outputs, not ``forward``'s
locals.

Saved tensors go through ``save_for_backward``, so ``torch.utils.checkpoint``
drops and recomputes them like any other.  The explicit stepper writes its
stages into one (s, b, f) buffer and hands ``stage_accum`` the prefix
``K[:i]`` before it writes ``K[i]``.  The prefix never changes after the
call, but it shares the buffer's version counter, so the Functions save
``_frozen(K)``: the same memory under a counter of its own.

``interp_eval`` writes the dense output, and ``fused_event_commit`` the
event states, in place on the card.  Under autograd their Functions write
into a copy instead, so no tensor autograd may have saved, and no input of a
checkpointed block that is recomputed later, is changed.  Without grad the
in-place contracts of ``core/step.py`` and ``core/events.py`` stay.

The fused steps keep their error estimate, and ``fused_step_poly`` its
stages, on chip; under autograd their launches also write them out
(``cuda_impl.fused_step(..., errs=)``, ``fused_step_poly(..., stages=,
stage_args=, errs=)``), and the backwards read those bits: the estimate is
a difference of two solutions and the polynomial's derivative at a stage
argument may cancel, so a recomputation that rounds apart moves them, and
in float32 the gradient, by far more than the backward's own rounding.
``fused_step_poly``'s backward walks the stage recursion back over the
stages and their arguments.  ``batched_linsolve``
saves its matrix by reference (the stepper's chord matrix) and the
solution, never a factor: the backward solves ``A^T`` once, for
``g_rhs = A^{-T} g`` and ``g_A = -g_rhs x^T``.  ``batched_lu_factor``'s
backward is torch's own ``lu_factor_ex`` backward on the kernel's factors.
"""

from __future__ import annotations

import functools
import weakref
from typing import NamedTuple

import numpy as np
import torch
from torch._C import _functorch
from torch._functorch.pyfunctorch import temporarily_pop_interpreter_stack

from . import cuda_impl, ref


def _frozen(t):
    """``t``'s memory, shape and strides under a version counter of its own
    (see the module docstring); a ``torch.func`` wrapper, which has no
    memory, as it is."""
    if _functorch.is_functorch_wrapped_tensor(t):
        return t
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


def _poly_coeffs(poly, like):
    """``poly_eval``'s coefficients as it makes them: a float stays a Python
    number, a per-feature tuple becomes an (f,) tensor (copied once)."""
    return [float(c) if np.ndim(c) == 0 else _cached_weights(tuple(map(float, c)), like.dtype,
                                                              like.device)
            for c in poly]


def _sum_to(grad, tol):
    """The gradient of a broadcast tolerance, summed back to its shape:
    a scalar, (b,) (broadcast as (b, 1)) or (b, f)."""
    if tol.ndim == 1:
        return grad.sum_to_size(tol.shape[0], 1).reshape(tol.shape)
    return grad.sum_to_size(tol.shape)


def _add(a, b):
    """``a + b``, either of which may be a gradient that did not arrive."""
    if a is None:
        return b
    if b is None:
        return a
    return a + b


def _split(mask, g):
    """The gradients of ``where(mask, a, b)`` in a and in b (None for None)."""
    if g is None:
        return None, None
    return torch.where(mask, g, 0.0), torch.where(mask, 0.0, g)


def _save_tols(ctx, atol, rtol):
    """The tensor tolerances to save; numbers stay on ``ctx``."""
    ctx.tols = tuple(None if isinstance(t, torch.Tensor) else t for t in (atol, rtol))
    return [t for t in (atol, rtol) if isinstance(t, torch.Tensor)]


def _load_tols(ctx, saved):
    saved = iter(saved)
    return tuple(next(saved) if t is None else t for t in ctx.tols)


def _or_zeros(t, like):
    """A tangent, or zeros shaped like ``like`` where it does not exist."""
    return torch.zeros_like(like) if t is None else t


def _fresh(out, t):
    """``out``, copied where it is the input tangent ``t`` itself: a jvp
    returns tangents of its own."""
    return out.clone() if out is not None and out is t else out


def _where(mask, a, b):
    """The tangent of ``where(mask, x, y)`` from theirs (None where absent)."""
    if a is None and b is None:
        return None
    return torch.where(mask, 0.0 if a is None else a, 0.0 if b is None else b)


def _sum(*terms):
    """The sum of the tangents that exist, left to right (None: none does)."""
    out = None
    for t in terms:
        out = _add(out, t)
    return out


def _mul(t, x):
    """``t * x`` for a tangent ``t`` that may not exist."""
    return None if t is None else t * x


def _save_for_jvp(ctx, inputs, output, *tensors, nondiff=()):
    """``ctx.save_for_forward`` of what the jvp reads, in forward mode only
    (a reverse-mode call keeps nothing more alive); absent tangents then
    reach the jvp as None.  Records which outputs take a tangent: the
    floating ones, but for those at the indices ``nondiff`` (marked
    non-differentiable)."""
    if cuda_impl.forward_mode() or any(map(cuda_impl.transformed, inputs)):
        ctx.set_materialize_grads(False)
        ctx.save_for_forward(*tensors)
        outs = output if isinstance(output, tuple) else (output,)
        ctx.tangent_like = tuple(
            None if i in nondiff or not isinstance(o, torch.Tensor) or not o.is_floating_point()
            else (o.shape, o.dtype, o.device) for i, o in enumerate(outs))


def _filled(ctx, out):
    """A jvp's tangents with zeros where a floating output takes a tangent
    and the rule gave None (forward AD sets every such output's tangent)."""
    many = isinstance(out, tuple)
    outs = out if many else (out,)
    outs = tuple(torch.zeros(like[0], dtype=like[1], device=like[2])
                 if t is None and like is not None else t
                 for t, like in zip(outs, ctx.tangent_like))
    return outs if many else outs[0]


def _jvp(rule):
    """A Function's ``jvp`` staticmethod from ``rule(ctx, saved, *tangents)``.

    Under ``torch.autograd.forward_ad`` the rule runs on the saved tensors
    and tangents as given.  Under ``torch.func.jvp`` they come wrapped at the
    transform's level, with forward AD off: they are unwrapped, and the rule
    runs with that level popped, so that a kernel reads plain tensors and
    what it makes is plain; its tangents are wrapped back.  A transform
    around that one (wrappers under the wrappers) is refused: the Functions
    carry one level of forward mode."""
    def jvp(ctx, *tangents):
        saved = ctx.saved_tensors
        level = _functorch.maybe_current_level()
        if level is None:
            return _filled(ctx, rule(ctx, saved, *tangents))

        def down(t):
            if not isinstance(t, torch.Tensor):
                return t
            if _functorch.maybe_get_level(t) == level:
                t = _functorch.get_unwrapped(t)
            if _functorch.is_functorch_wrapped_tensor(t):
                raise NotImplementedError(
                    "forward mode through the solver kernels' autograd Functions takes one "
                    "torch.func transform; nested transforms (jvp of jvp, jacfwd, vmap) are "
                    "not supported on the card")
            return t

        saved, tangents = tuple(map(down, saved)), tuple(map(down, tangents))
        with temporarily_pop_interpreter_stack():
            out = _filled(ctx, rule(ctx, saved, *tangents))

        def up(t):
            return _functorch._wrap_for_grad(t, level) if isinstance(t, torch.Tensor) else t

        return tuple(map(up, out)) if isinstance(out, tuple) else up(out)

    return staticmethod(jvp)


# ----------------------------------------------------- shared derivatives


def _update_grads(g1, ge, dt, K, weights, need_K, need_dt, gdt=None):
    """The gradients in K and dt of ``fused_update``'s two products ``dt *
    (b_sol . K)`` (cotangent ``g1``) and ``dt * (b_err . K)`` (``ge``);
    ``gdt`` is what dt's gradient holds before them."""
    # Autograd reaches the err product first (it was recorded last).
    parts = [(gr, _weights(w, K)) for gr, w in ((ge, weights[1]), (g1, weights[0]))
             if gr is not None]
    gK = None
    if need_dt:
        for gr, w in parts:
            gdt = _add(gdt, (gr * torch.tensordot(w, K, dims=1)).sum(-1))
    if need_K:
        for gr, w in parts:
            gK = _add(gK, w[:, None, None] * (gr * dt[:, None]))
    return gK, gdt


def _rms_grads(g, num, scale, out, need_scale):
    """``out = sqrt(mean((num / scale)**2, -1))``: the gradients in num and
    scale.  sqrt, mean over the features, ratio * ratio (both factors the
    same tensor: two equal terms), then the quotient."""
    ratio = num / scale
    gq = (g / (2 * out))[:, None].expand(num.shape) / num.shape[-1]
    gratio = gq * ratio + gq * ratio
    gscale = -gratio * ((num / scale) / scale) if need_scale else None
    return gratio / scale, gscale


def _error_norm_grads(g, out, err, y0, y1, atol, rtol, needs, failed=None):
    """``error_norm(err, y0, y1, atol, rtol) == out``: the gradients in
    (err, y0, y1, atol, rtol) for those ``needs`` names.  ``failed`` rows
    had their ratio set to inf after the norm: their ``out`` is recomputed."""
    need_y0, need_y1, need_atol, need_rtol = needs
    # A scalar tolerance stays a number: as a tensor on the card it would
    # be a copy from host memory, which waits for the device.
    atol_b, rtol_b = (t[:, None] if isinstance(t, torch.Tensor) and t.ndim == 1 else t
                      for t in (atol, rtol))
    a0, a1 = torch.abs(y0), torch.abs(y1)
    m = torch.maximum(a0, a1)
    scale = atol_b + rtol_b * m
    if failed is not None:
        ratio = err / scale
        out = torch.where(failed, torch.sqrt(torch.mean(ratio * ratio, dim=-1)), out)
    gerr, gscale = _rms_grads(g, err, scale, out,
                              need_y0 or need_y1 or need_atol or need_rtol)
    gy0 = gy1 = gatol = grtol = None
    if gscale is not None:
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


def _horner_grads(ga, xe, cs, reduce, need_c, need_x):
    """Horner's ``p = ((c_n x + c_{n-1}) x + ...) x + c_0`` (``cs`` low to
    high, broadcast against the cotangent ``ga`` of p; ``xe`` broadcast too):
    (the x gradient summed over the last axis, keepdim; each coefficient's
    through ``reduce``).  The partial sums acc_k = acc_{k+1} * x + c_k, from
    the top coefficient down, walked back from acc_0."""
    partial = [cs[-1]]
    if need_x:
        for c in cs[-2:0:-1]:
            partial.append(partial[-1] * xe + c)
    gc = [None] * len(cs)
    gx = None
    for k in range(len(cs) - 1):
        if need_c[k]:
            gc[k] = reduce(ga)
        if need_x:
            gx = _add(gx, (ga * partial[-1 - k]).sum(dim=-1, keepdim=True))
        ga = ga * xe
    if need_c[-1]:
        gc[-1] = reduce(ga)
    return gx, gc


def _poly_partials(y, cs):
    """``poly_eval``'s values before each multiply by y: acc_0 = the top
    coefficient, acc_{j+1} = acc_j * y + c."""
    accs = [cs[-1]]
    for c in cs[-2:0:-1]:
        accs.append(accs[-1] * y + c)
    return accs


def _poly_grad(g, y, cs, accs=None):
    """The gradient in y of ``poly_eval(y, poly)`` (``cs`` from
    ``_poly_coeffs``) for the cotangent g: each multiply ``acc * y`` walked
    back from the last; None for a constant polynomial."""
    if len(cs) < 2:
        return None
    accs = _poly_partials(y, cs) if accs is None else accs
    gy = None
    for j in range(len(accs) - 1, -1, -1):
        gy = _add(gy, g * accs[j])
        if j:
            g = g * y
    return gy


def _pow_grad(g, x, e):
    """torch's ``pow`` backward for a Python-number exponent."""
    if e == 0.0:
        return torch.zeros_like(x)
    return g * (e * x.pow(e - 1))


def _pid_grads(ctrl, ratio, dt, pi1, pi2, g_next, g_inv1, g_inv2):
    """``ref.pid_update``: the gradients in (err_ratio, dt, prev_inv,
    prev2_inv) of its outputs dt_next, new_inv, new_inv2 (cotangents
    ``g_next``, ``g_inv1``, ``g_inv2``).  The factor is recomputed from the
    saved ratio, op by op as the plain version builds it."""
    b1, b2, b3, safety, factor_min, factor_max, dt_min, dt_max = ctrl
    finite = torch.isfinite(ratio)
    accept = finite & (ratio <= 1.0)
    g_inv, g_pi1 = _split(accept, g_inv1)
    a, g_pi2 = _split(accept, g_inv2)
    g_pi1 = _add(g_pi1, a)
    g_dt = None
    positive = finite & (ratio > 0.0)
    recip = torch.reciprocal(torch.where(positive, ratio, 1.0))
    if g_next is not None:
        inv = recip * 1.0
        p1, p2, p3 = inv**b1, pi1**b2, pi2**b3
        s1 = safety * p1
        s2 = s1 * p2
        f_b = s2 * p3
        f_a = torch.where(ratio == 0.0, factor_max, f_b)
        f_0 = torch.where(finite, f_a, 0.5)
        f_1 = torch.clamp(f_0, factor_min, factor_max)
        f_2 = torch.where(accept, f_1, torch.clamp(f_1, max=1.0)).to(dt.dtype)
        abs_dt = torch.abs(dt)
        prod = abs_dt * f_2
        # dt_next = sign(dt) * clamp(|dt| * factor, dt_min, dt_max); sign' = 0.
        g_prod = torch.where((prod >= dt_min) & (prod <= dt_max), g_next * torch.sign(dt), 0.0)
        g_dt = (g_prod * f_2) * torch.sgn(dt)
        ga, gb = _split(accept, g_prod * abs_dt)
        g_f1 = ga + torch.where(f_1 <= 1.0, gb, 0.0)
        g_f0 = torch.where((f_0 >= factor_min) & (f_0 <= factor_max), g_f1, 0.0)
        g_fb = torch.where(ratio == 0.0, 0.0, torch.where(finite, g_f0, 0.0))
        g_s2, g_p3 = g_fb * p3, g_fb * s2
        g_s1, g_p2 = g_s2 * p2, g_s2 * s1
        g_inv = _add(g_inv, _pow_grad(g_s1 * safety, inv, b1))
        g_pi1 = _add(g_pi1, _pow_grad(g_p2, pi1, b2))
        g_pi2 = _add(g_pi2, _pow_grad(g_p3, pi2, b3))
    g_ratio = None
    if g_inv is not None:  # inv = reciprocal(safe) * 1.0
        g_ratio = torch.where(positive, -(g_inv * 1.0) * (recip * recip), 0.0)
    return g_ratio, g_dt, g_pi1, g_pi2


class _StepConfig(NamedTuple):
    """The static half of a fused step call (``ref.fused_step``'s keywords;
    ``a``, ``poly`` and ``fsal`` for ``fused_step_poly``)."""

    b_sol: tuple
    b_err: tuple
    ctrl: tuple
    want_coeffs: bool
    ctrl_mode: str
    a: object = None
    poly: tuple = ()
    fsal: bool = True


def _step_grads(cfg, y, K, f1, f0, safe_dt, dt_cur, pi1, pi2, running, failed, atol, rtol,
                y1, err, ratio, accept, grads, need):
    """The backward of ``ref.fused_step`` from its saved inputs and the
    kernel's y1, error estimate, ratio and accept, for the cotangents ``grads`` of (y1,
    err_ratio, y_out, f_out, t_out, dt_out, new_inv, new_inv2, c0, c1, c2,
    c3).  ``need``: the names of the inputs whose gradients are wanted.
    Returns a dict name -> gradient (K's an (s, b, f) tensor or None).

    Where several terms meet in one input, they are summed in the order
    autograd of the plain op sums them (the output's own cotangent, then the
    operations from the last recorded back), so that float32 sums with
    cancellation round alike."""
    (g_y1, g_ratio, g_yout, g_fout, g_tout, g_dtout, g_inv1, g_inv2,
     g_c0, g_c1, g_c2, g_c3) = grads
    acc_f = accept[:, None]
    k0 = K[0] if f0 is None else f0
    out = {}
    gy, gy1, gf1, gk0, gdt = g_c0, g_y1, None, None, None
    # ref.hermite_coeffs: c0 = y, c1 = h f0, c2 = 3 (y1 - y) - h (2 f0 + f1),
    # c3 = 2 (y - y1) + h (f0 + f1); h = dt[:, None], summed per product.
    hdt = safe_dt[:, None]
    if g_c3 is not None:
        gdt = _add(gdt, (g_c3 * (k0 + f1)).sum(-1))
        ge = g_c3 * hdt
        gk0, gf1 = _add(gk0, ge), _add(gf1, ge)
        gd = g_c3 * 2.0
        gy, gy1 = _add(gy, gd), _add(gy1, -gd)
    if g_c2 is not None:
        gb = -g_c2
        gdt = _add(gdt, (gb * (2.0 * k0 + f1)).sum(-1))
        ge = gb * hdt
        gk0, gf1 = _add(gk0, ge * 2.0), _add(gf1, ge)
        gd = g_c2 * 3.0
        gy1, gy = _add(gy1, gd), _add(gy, -gd)
    if g_c1 is not None:
        gdt = _add(gdt, (g_c1 * k0).sum(-1))
        gk0 = _add(gk0, g_c1 * hdt)
    a, b = _split(running, g_dtout)
    g_next, out["dt_cur"] = a, b
    out["t_new"], out["t"] = _split(accept, g_tout)
    a, b = _split(acc_f, g_fout)
    gf1, gk0 = _add(gf1, a), _add(gk0, b)
    a, b = _split(acc_f, g_yout)
    gy1, gy = _add(gy1, a), _add(gy, b)
    if cfg.ctrl_mode == "fixed":  # dt_next = dt_cur, the history passes through
        g_r = g_ratio
        out["dt_cur"] = _add(out["dt_cur"], g_next)
        out["prev_inv"], out["prev2_inv"] = g_inv1, g_inv2
    else:
        g_pid, g_dtc, out["prev_inv"], out["prev2_inv"] = _pid_grads(
            cfg.ctrl, ratio, dt_cur, pi1, pi2, g_next, g_inv1, g_inv2)
        out["dt_cur"] = _add(out["dt_cur"], g_dtc)
        g_r = _add(g_ratio, g_pid)
    gerr = None
    if g_r is not None:
        if failed is not None:  # where(failed, inf, ratio)
            g_r = torch.where(failed, 0.0, g_r)
        gerr, gy0, gy1n, out["atol"], out["rtol"] = _error_norm_grads(
            g_r, ratio, err, y, y1, atol, rtol,
            (True, True, "atol" in need, "rtol" in need), failed=failed)
        gy, gy1 = _add(gy, gy0), _add(gy1, gy1n)
    gK, out["safe_dt"] = _update_grads(gy1, gerr, safe_dt, K, (cfg.b_sol, cfg.b_err), True,
                                       True, gdt=gdt)
    out["y"] = _add(gy, gy1)
    out["f1"] = gf1
    if gk0 is not None and f0 is not None:
        out["f0"] = gk0
    elif gk0 is not None:
        gK = torch.zeros_like(K) if gK is None else gK
        gK[0] += gk0
    out["K"] = gK
    return out


# ------------------------------------------------------ shared tangents


def _combine_tangent(ty, tK, tdt, dt, K, w):
    """The jvp of ``y + dt[:, None] * tensordot(w, K)`` (``ty`` None: of
    the product alone); ``tK`` a tensor or a list of stage tangents."""
    if isinstance(tK, list):
        tK = None if all(t is None for t in tK) else torch.stack(
            [_or_zeros(t, K[0]) for t in tK])
    t = _sum(_mul(tdt[:, None] if tdt is not None else None, torch.tensordot(w, K, dims=1)),
             None if tK is None else dt[:, None] * torch.tensordot(w, tK, dims=1))
    return _add(ty, t)


def _update_tangents(ty, tK, tdt, dt, K, weights):
    """The jvp of ``ref.fused_update``'s products, one per weight row: the
    first adds y's tangent (y1), the others do not (err)."""
    return [_combine_tangent(ty if i == 0 else None, tK, tdt, dt, K, _weights(w, K))
            for i, w in enumerate(weights)]


def _rms_tangent(num, tnum, scale, tscale, out):
    """The jvp of ``out = sqrt(mean((num / scale)**2, -1))``: the quotient's
    (``(num' - scale' ratio) / scale``), the square's (two equal terms), the
    mean and sqrt's ``/ (2 out)`` -- NaN in a row whose out is 0, as there."""
    if tnum is None and tscale is None:
        return None
    ratio = num / scale
    tratio = _add(tnum, None if tscale is None else -(tscale * ratio)) / scale
    return torch.mean(tratio * ratio + tratio * ratio, dim=-1) / (2 * out)


def _error_norm_tangent(out, err, terr, y0, ty0, y1, ty1, atol, tatol, rtol, trtol):
    """The jvp of ``ref.error_norm`` at its value ``out``: ``abs`` by
    ``sgn`` (abs'(0) = 0), ``maximum`` by torch's rule (a tie takes half of
    each), the scale, then ``_rms_tangent``."""
    def col(t):
        return t[:, None] if isinstance(t, torch.Tensor) and t.ndim == 1 else t

    atol_b, rtol_b, tatol_b, trtol_b = map(col, (atol, rtol, tatol, trtol))
    a0, a1 = torch.abs(y0), torch.abs(y1)
    m = torch.maximum(a0, a1)
    tm = None
    if ty0 is not None or ty1 is not None:
        ta0 = _or_zeros(_mul(ty0, torch.sgn(y0)), y0)
        ta1 = _or_zeros(_mul(ty1, torch.sgn(y1)), y1)
        w = torch.where(a0 == a1, 0.5, (a0 > a1).to(a0.dtype))
        tm = ta1 + w * (ta0 - ta1)
    tscale = _sum(tatol_b, _mul(trtol_b, m), _mul(tm, rtol_b))
    return _rms_tangent(err, terr, atol_b + rtol_b * m, tscale, out)


def _poly_value(y, cs):
    """``poly_eval(y, poly)`` from ``_poly_coeffs``'s coefficients."""
    if len(cs) > 1:
        return _poly_partials(y, cs)[-1] * y + cs[0]
    return torch.as_tensor(cs[0], dtype=y.dtype, device=y.device).expand(y.shape)


def _poly_tangent(y, ty, cs):
    """The jvp of ``poly_eval(y, poly)`` (``cs`` from ``_poly_coeffs``):
    each multiply ``acc * y`` forward, ``y' acc + acc' y``; None for a
    constant polynomial or no tangent."""
    if ty is None or len(cs) < 2:
        return None
    t = None
    for acc in _poly_partials(y, cs):
        t = ty * acc if t is None else ty * acc + t * y
    return t


def _pow_tangent(t, x, e):
    """torch's ``pow`` jvp for a Python-number exponent."""
    if t is None:
        return None
    if e == 0.0:
        return torch.zeros_like(x)
    return t * (e * x.pow(e - 1))


def _pid_tangents(ctrl, ratio, tratio, dt, tdt, pi1, tpi1, pi2, tpi2):
    """The jvp of ``ref.pid_update``'s dt_next, new_inv and new_inv2, op by
    op as the plain version builds them (``where`` and ``clamp`` pass a
    tangent where they pass the value; sign' = 0)."""
    b1, b2, b3, safety, factor_min, factor_max, dt_min, dt_max = ctrl
    finite = torch.isfinite(ratio)
    accept = finite & (ratio <= 1.0)
    positive = finite & (ratio > 0.0)
    recip = torch.reciprocal(torch.where(positive, ratio, 1.0))
    inv = recip * 1.0
    tinv = None
    if tratio is not None:  # inv = reciprocal(safe) * 1.0
        tinv = (-torch.where(positive, tratio, 0.0) * (recip * recip)) * 1.0
    p1, p2, p3 = inv**b1, pi1**b2, pi2**b3
    s1 = safety * p1
    s2 = s1 * p2
    ts1 = _mul(_pow_tangent(tinv, inv, b1), safety)
    ts2 = _sum(_mul(_pow_tangent(tpi1, pi1, b2), s1), _mul(ts1, p2))
    tf = _sum(_mul(_pow_tangent(tpi2, pi2, b3), s2), _mul(ts2, p3))
    tnext = None
    f_b = s2 * p3
    f_0 = torch.where(finite, torch.where(ratio == 0.0, factor_max, f_b), 0.5)
    f_1 = torch.clamp(f_0, factor_min, factor_max)
    f_2 = torch.where(accept, f_1, torch.clamp(f_1, max=1.0)).to(dt.dtype)
    if tf is not None:
        tf = torch.where(finite, torch.where(ratio == 0.0, 0.0, tf), 0.0)
        tf = torch.where((f_0 >= factor_min) & (f_0 <= factor_max), tf, 0.0)
        tf = torch.where(accept, tf, torch.where(f_1 <= 1.0, tf, 0.0))
    abs_dt = torch.abs(dt)
    tprod = _sum(_mul(tf, abs_dt), _mul(_mul(tdt, torch.sgn(dt)), f_2))
    if tprod is not None:  # dt_next = sign(dt) * clamp(|dt| * factor, dt_min, dt_max)
        prod = abs_dt * f_2
        tnext = torch.sign(dt) * torch.where((prod >= dt_min) & (prod <= dt_max), tprod, 0.0)
    return tnext, _where(accept, tinv, tpi1), _where(accept, tpi1, tpi2)


def _hermite_tangents(y0, ty0, y1, ty1, f0, tf0, f1, tf1, dt, tdt):
    """The jvp of ``ref.hermite_coeffs``: c0 = y0 (a copy of its tangent),
    c1 = h f0, c2 = 3 (y1 - y0) - h (2 f0 + f1), c3 = 2 (y0 - y1) + h (f0 +
    f1); h = dt[:, None]."""
    h, th = dt[:, None], None if tdt is None else tdt[:, None]
    tc0 = None if ty0 is None else ty0.clone()
    tc1 = _sum(_mul(th, f0), _mul(tf0, h))
    tdy = _sum(ty1, _mul(ty0, -1.0))
    tc2 = _sum(_mul(tdy, 3.0), _mul(_sum(_mul(th, 2.0 * f0 + f1),
                                         _mul(_sum(_mul(tf0, 2.0), tf1), h)), -1.0))
    tc3 = _sum(_mul(tdy, -2.0), _sum(_mul(th, f0 + f1), _mul(_sum(tf0, tf1), h)))
    return [tc0, tc1, tc2, tc3]


def _step_tangents(cfg, y, ty, K, tK, f1, tf1, f0, tk0, tt, tt_new, safe_dt, tsafe_dt, dt_cur,
                   tdt_cur, pi1, tpi1, pi2, tpi2, running, failed, atol, tatol, rtol, trtol,
                   y1, err, ratio, accept):
    """The jvp of ``ref.fused_step`` from its saved inputs and the kernel's
    y1, error estimate, ratio and accept: the tangents of its fourteen
    outputs (y1, err_ratio, accept, y_out, f_out, t_out, dt_out, new_inv,
    new_inv2, c0..c3, the error estimate), None for the non-differentiable
    ones and for those no tangent reaches.  A failed row's ratio is inf
    whatever its norm: its tangent is 0."""
    ty1, terr = _update_tangents(ty, tK, tsafe_dt, safe_dt, K, (cfg.b_sol, cfg.b_err))
    tratio = _error_norm_tangent(ratio, err, terr, y, ty, y1, ty1, atol, tatol, rtol, trtol)
    if failed is not None and tratio is not None:
        tratio = torch.where(failed, 0.0, tratio)
    if cfg.ctrl_mode == "fixed":  # dt_next = dt_cur, the history passes through
        tnext, tinv, tinv2 = tdt_cur, tpi1, tpi2
    else:
        tnext, tinv, tinv2 = _pid_tangents(cfg.ctrl, ratio, tratio, dt_cur, tdt_cur, pi1, tpi1,
                                           pi2, tpi2)
    acc_f = accept[:, None]
    k0 = K[0] if f0 is None else f0
    coeffs = (_hermite_tangents(y, ty, y1, ty1, k0, tk0, f1, tf1, safe_dt, tsafe_dt)
              if cfg.want_coeffs else [None] * 4)
    return (ty1, tratio, None, _where(acc_f, ty1, ty), _where(acc_f, tf1, tk0),
            _where(accept, tt_new, tt), _where(running, tnext, tdt_cur), tinv, tinv2, *coeffs,
            None)


# -------------------------------------------------------- the explicit path


class StageAccum(torch.autograd.Function):
    """``y + dt[:, None] * sum_j coeffs[j] * K[j]``; ``coeffs`` are tableau
    constants, not differentiated.  Linear in (y, K) for a given dt: the
    tangent is the kernel on (0, K'), then on (that, dt', K), plus y'."""

    @staticmethod
    def forward(y, dt, K, coeffs):
        return cuda_impl.stage_accum(y, dt, K, coeffs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        y, dt, K, coeffs = inputs
        ctx.coeffs = coeffs
        ctx.save_for_backward(dt, _frozen(K))
        _save_for_jvp(ctx, inputs, output, dt, K)

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

    @_jvp
    def jvp(ctx, saved, ty, tdt, tK, _):
        dt, K = saved
        # y' + (dt' acc + dt acc'), summed as the plain op's jvp sums it: the
        # error estimate's tangent cancels, and amplifies any other order's
        # rounding.
        t = None
        if tK is not None:
            t = cuda_impl.stage_accum(torch.zeros_like(K[0]), dt, tK.contiguous(), ctx.coeffs)
        if tdt is not None:
            t = cuda_impl.stage_accum(_or_zeros(t, K[0]), tdt.contiguous(), K, ctx.coeffs)
        return _fresh(_add(ty, t), ty)


class FusedUpdate(torch.autograd.Function):
    """``(y + dt * (b_sol . K), dt * (b_err . K))``.  Tangent: the kernel on
    (0, K'), then on (that, K) with dt' for the dt term (its error part
    added), plus y'."""

    @staticmethod
    def forward(y, K, dt, b_sol, b_err):
        return cuda_impl.fused_update(y, K, dt, b_sol, b_err)

    @staticmethod
    def setup_context(ctx, inputs, output):
        y, K, dt, b_sol, b_err = inputs
        ctx.weights = (b_sol, b_err)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(dt, _frozen(K))
        _save_for_jvp(ctx, inputs, output, dt, K)

    @staticmethod
    def backward(ctx, g1, ge):
        dt, K = ctx.saved_tensors
        need_y, need_K, need_dt, _, _ = ctx.needs_input_grad
        gK, gdt = _update_grads(g1, ge, dt, K, ctx.weights, need_K, need_dt)
        return (g1 if need_y else None), gK, gdt, None, None

    @_jvp
    def jvp(ctx, saved, ty, tK, tdt, _bs, _be):
        dt, K = saved
        # Summed as StageAccum's: y' + (dt' acc + dt acc').
        t1 = te = None
        if tK is not None:
            t1, te = cuda_impl.fused_update(torch.zeros_like(K[0]), tK.contiguous(), dt,
                                            *ctx.weights)
        if tdt is not None:
            t1, e2 = cuda_impl.fused_update(_or_zeros(t1, K[0]), K, tdt.contiguous(),
                                            *ctx.weights)
            te = _add(te, e2)
        return _fresh(_add(ty, t1), ty), te


class ErrorNorm(torch.autograd.Function):
    """``sqrt(mean((err / (atol + rtol * max(|y0|, |y1|)))**2, -1))``."""

    @staticmethod
    def forward(err, y0, y1, atol, rtol):
        return cuda_impl.error_norm(err, y0, y1, atol, rtol)

    @staticmethod
    def setup_context(ctx, inputs, output):
        err, y0, y1, atol, rtol = inputs
        tols = _save_tols(ctx, atol, rtol)
        ctx.save_for_backward(err, y0, y1, output, *tols)
        _save_for_jvp(ctx, inputs, output, err, y0, y1, output, *tols)

    @staticmethod
    def backward(ctx, g):
        err, y0, y1, out, *tols = ctx.saved_tensors
        atol, rtol = _load_tols(ctx, tols)
        need_err, need_y0, need_y1, need_atol, need_rtol = ctx.needs_input_grad
        gerr, gy0, gy1, gatol, grtol = _error_norm_grads(
            g, out, err, y0, y1, atol, rtol, (need_y0, need_y1, need_atol, need_rtol))
        return (gerr if need_err else None), gy0, gy1, gatol, grtol

    @_jvp
    def jvp(ctx, saved, terr, ty0, ty1, tatol, trtol):
        err, y0, y1, out, *tols = saved
        atol, rtol = _load_tols(ctx, tols)
        return _error_norm_tangent(out, err, terr, y0, ty0, y1, ty1, atol, tatol, rtol, trtol)


class InterpEval(torch.autograd.Function):
    """The masked Horner write ``where(mask, p(x), out)`` (with ``cursor``,
    on the (b, W) window at each row's cursor).  Writes into a copy of
    ``out``; the coefficients come last, as varargs.  Tangent: the kernel
    on the coefficients' tangents into a copy of out's, plus the kernel on
    the derivative polynomial (c1, 2 c2, 3 c3) times x'."""

    @staticmethod
    def forward(x, mask, out, cursor, *coeffs):
        return cuda_impl.interp_eval(coeffs, x, mask, out.clone(), cursor)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, mask, out, cursor, *coeffs = inputs
        ctx.windowed = cursor is not None
        ctx.save_for_backward(x, mask, *coeffs, *((cursor,) if ctx.windowed else ()))
        _save_for_jvp(ctx, inputs, output, x, mask, out, *coeffs,
                      *((cursor,) if ctx.windowed else ()))

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
        cs = [c[:, None, :] for c in coeffs]
        cs[-1] = cs[-1].expand(gw.shape)
        gx, gc = _horner_grads(torch.where(m3, gw, 0.0), x[:, :, None], cs,
                               lambda t: t.sum(dim=1), need_c, need_x)
        return (gx[:, :, 0] if gx is not None else None), None, gout, None, *gc

    @_jvp
    def jvp(ctx, saved, tx, _tmask, tout, _tcursor, *tc):
        x, mask, out, *coeffs = saved
        cursor = coeffs.pop() if ctx.windowed else None
        if tout is None and tx is None and all(t is None for t in tc):
            return None
        c0 = coeffs[0]
        res = cuda_impl.interp_eval(tuple(_or_zeros(t, c0).contiguous() for t in tc), x, mask,
                                    torch.zeros_like(out) if tout is None else tout.clone(),
                                    cursor)
        if tx is not None:
            # p'(x) x': the derivative polynomial written into zeros, times x'
            # in the written cells.
            c1, c2, c3 = coeffs[1:]
            slope = cuda_impl.interp_eval((c1, 2.0 * c2, 3.0 * c3, torch.zeros_like(c0)), x,
                                          mask, torch.zeros_like(out), cursor)
            tx = torch.where(mask, tx, 0.0)
            if cursor is not None:
                idx = cursor[:, None] + torch.arange(x.shape[1], device=cursor.device)
                tx = torch.zeros(out.shape[:2], dtype=tx.dtype, device=tx.device).scatter(
                    1, idx, tx)
            res = res + slope * tx[:, :, None]
        return res


# ---------------------------------------------------------- the fused step


class FusedStep(torch.autograd.Function):
    """``ref.fused_step``: the combine, the WRMS ratio, the PID (or fixed)
    decision, the masked commit and the Hermite coefficients c1..c3 (c0 is
    the input y, returned as a copy).  ``accept`` is
    non-differentiable; the error estimate the launch writes out is a last,
    non-differentiable output."""

    @staticmethod
    def forward(y, K, f1, t, t_new, dt_cur, safe_dt, running, prev_inv, prev2_inv,
                atol, rtol, failed, f0, cfg):
        err = torch.empty_like(y)
        out = cuda_impl.fused_step(
            y, K, f1, t, t_new, dt_cur, safe_dt, running, prev_inv, prev2_inv, atol, rtol,
            b_sol=cfg.b_sol, b_err=cfg.b_err, ctrl=cfg.ctrl, want_coeffs=cfg.want_coeffs,
            ctrl_mode=cfg.ctrl_mode, failed=failed, f0=f0, errs=err)
        return (*out[:9], *_coeff_outs(out[9], y), err)

    @staticmethod
    def setup_context(ctx, inputs, output):
        (y, K, f1, t, t_new, dt_cur, safe_dt, running, prev_inv, prev2_inv, atol, rtol,
         failed, f0, cfg) = inputs
        y1, ratio, accept = output[:3]
        err = output[-1]
        ctx.mark_non_differentiable(accept, err)
        ctx.set_materialize_grads(False)
        ctx.cfg = cfg
        ctx.optional = (failed is not None, f0 is not None)
        tols = _save_tols(ctx, atol, rtol)
        opt = [x for x in (failed, f0) if x is not None]
        ctx.save_for_backward(y, _frozen(K), _frozen(f1), safe_dt, dt_cur, prev_inv,
                              prev2_inv, running, y1, err, ratio, accept, *opt, *tols)
        _save_for_jvp(ctx, inputs, output, y, K, f1, safe_dt, dt_cur, prev_inv, prev2_inv,
                      running, y1, err, ratio, accept, *opt, *tols, nondiff=(13,))

    @staticmethod
    def backward(ctx, g_y1, g_ratio, _g_accept, *grads):
        grads = grads[:-1]  # the error estimate's
        (y, K, f1, safe_dt, dt_cur, pi1, pi2, running, y1, err, ratio, accept,
         *rest) = ctx.saved_tensors
        failed = rest.pop(0) if ctx.optional[0] else None
        f0 = rest.pop(0) if ctx.optional[1] else None
        atol, rtol = _load_tols(ctx, rest)
        names = ("y", "K", "f1", "t", "t_new", "dt_cur", "safe_dt", "running", "prev_inv",
                 "prev2_inv", "atol", "rtol", "failed", "f0")
        need = {n for n, w in zip(names, ctx.needs_input_grad) if w}
        out = _step_grads(ctx.cfg, y, K, f1, f0, safe_dt, dt_cur, pi1, pi2, running, failed,
                          atol, rtol, y1, err, ratio, accept, (g_y1, g_ratio, *grads), need)
        return (*(out.get(n) if n in need else None for n in names), None)

    @_jvp
    def jvp(ctx, saved, ty, tK, tf1, tt, tt_new, tdt_cur, tsafe_dt, _trunning, tpi1, tpi2,
            tatol, trtol, _tfailed, tf0, _tcfg):
        (y, K, f1, safe_dt, dt_cur, pi1, pi2, running, y1, err, ratio, accept,
         *rest) = saved
        failed = rest.pop(0) if ctx.optional[0] else None
        f0 = rest.pop(0) if ctx.optional[1] else None
        atol, rtol = _load_tols(ctx, rest)
        tk0 = tf0 if f0 is not None else (None if tK is None else tK[0])
        return _step_tangents(ctx.cfg, y, ty, K, tK, f1, tf1, f0, tk0, tt, tt_new, safe_dt,
                              tsafe_dt, dt_cur, tdt_cur, pi1, tpi1, pi2, tpi2, running, failed,
                              atol, tatol, rtol, trtol, y1, err, ratio, accept)


class FusedStepPoly(torch.autograd.Function):
    """``ref.fused_step_poly``: ``FusedStep`` with the stage recursion of the
    polynomial vector field (and the non-FSAL trailing evaluation) inside.
    The launch writes out its stages, their arguments and the error
    estimate (three last, non-differentiable outputs); the backward walks
    the recursion back over them: ``poly_eval``'s Horner derivative and
    ``stage_accum``'s, and the jvp walks it forward."""

    @staticmethod
    def forward(y, f0, t, t_new, dt_cur, safe_dt, running, prev_inv, prev2_inv, atol,
                rtol, cfg):
        K = torch.empty((len(cfg.b_sol),) + tuple(y.shape), dtype=y.dtype, device=y.device)
        err = torch.empty_like(y)
        Z = torch.empty((K.shape[0] - 1,) + tuple(y.shape), dtype=y.dtype, device=y.device)
        out = cuda_impl.fused_step_poly(
            y, f0, t, t_new, dt_cur, safe_dt, running, prev_inv, prev2_inv, atol, rtol,
            a=cfg.a, c=None, b_sol=cfg.b_sol, b_err=cfg.b_err, poly=cfg.poly, ctrl=cfg.ctrl,
            want_coeffs=cfg.want_coeffs, fsal=cfg.fsal, ctrl_mode=cfg.ctrl_mode, stages=K,
            errs=err, stage_args=Z)
        return (*out[:9], *_coeff_outs(out[9], y), K, Z, err)

    @staticmethod
    def setup_context(ctx, inputs, output):
        (y, f0, t, t_new, dt_cur, safe_dt, running, prev_inv, prev2_inv, atol, rtol,
         cfg) = inputs
        y1, ratio, accept = output[:3]
        K, Z, err = output[-3:]
        ctx.mark_non_differentiable(accept, K, Z, err)
        ctx.set_materialize_grads(False)
        ctx.cfg = cfg
        tols = _save_tols(ctx, atol, rtol)
        ctx.save_for_backward(y, K, Z, safe_dt, dt_cur, prev_inv, prev2_inv, running, y1, err,
                              ratio, accept, *tols)
        _save_for_jvp(ctx, inputs, output, y, K, Z, safe_dt, dt_cur, prev_inv, prev2_inv,
                      running, y1, err, ratio, accept, *tols, nondiff=(13, 14, 15))

    @staticmethod
    def backward(ctx, g_y1, g_ratio, _g_accept, *grads):
        grads = grads[:-3]  # the stages', their arguments' and the error estimate's
        (y, K, Z, safe_dt, dt_cur, pi1, pi2, running, y1, err, ratio, accept,
         *tols) = ctx.saved_tensors
        atol, rtol = _load_tols(ctx, tols)
        cfg = ctx.cfg
        names = ("y", "f0", "t", "t_new", "dt_cur", "safe_dt", "running", "prev_inv",
                 "prev2_inv", "atol", "rtol")
        need = {n for n, w in zip(names, ctx.needs_input_grad) if w}
        cs = _poly_coeffs(cfg.poly, y)
        if cfg.fsal:
            f1, y1_accs = K[-1], None
        else:  # the trailing evaluation f1 = poly(y1)
            y1_accs = _poly_partials(y1, cs)
            f1 = (y1_accs[-1] * y1 + cs[0] if len(cs) > 1
                  else torch.as_tensor(cs[0], dtype=y1.dtype, device=y1.device).expand(y1.shape))
        out = _step_grads(cfg, y, K, f1, None, safe_dt, dt_cur, pi1, pi2, running, None, atol,
                          rtol, y1, err, ratio, accept, (g_y1, g_ratio, *grads), need)
        gK, gy, gdt, gf1 = out["K"], out["y"], out["safe_dt"], out["f1"]
        if gf1 is not None:
            if cfg.fsal:
                gK = torch.zeros_like(K) if gK is None else gK
                gK[-1] += gf1
            else:
                gz = _poly_grad(gf1, y1, cs, y1_accs)
                if gz is not None:
                    gK_u, gdt_u = _update_grads(gz, None, safe_dt, K, (cfg.b_sol, cfg.b_err),
                                                True, True)
                    gK = gK_u if gK is None else gK + gK_u
                    gy, gdt = _add(gy, gz), _add(gdt, gdt_u)
        # The stage recursion K[i] = poly(Z[i - 1]), Z[i - 1] = y + dt * (a[i, :i]
        # . K[:i]), walked back from the last stage: Horner's derivative at the
        # kernel's arguments, then stage_accum's.
        a = np.asarray(cfg.a, dtype=np.float64)
        if gK is not None:
            for i in range(len(a) - 1, 0, -1):
                w = _weights(a[i, :i], K)
                acc = torch.tensordot(w, K[:i], dims=1)
                gz = _poly_grad(gK[i], Z[i - 1], cs)
                if gz is None:
                    continue
                gy = _add(gy, gz)
                gdt = _add(gdt, (gz * acc).sum(-1))
                gK[:i] += w[:, None, None] * (gz * safe_dt[:, None])
        out.update(y=gy, safe_dt=gdt, f0=None if gK is None else gK[0])
        return (*(out.get(n) if n in need else None for n in names), None)

    @_jvp
    def jvp(ctx, saved, ty, tf0, tt, tt_new, tdt_cur, tsafe_dt, _trunning, tpi1, tpi2, tatol,
            trtol, _tcfg):
        (y, K, Z, safe_dt, dt_cur, pi1, pi2, running, y1, err, ratio, accept,
         *tols) = saved
        atol, rtol = _load_tols(ctx, tols)
        cfg = ctx.cfg
        cs = _poly_coeffs(cfg.poly, y)
        # The stage recursion forward: Z[i - 1]' = stage_accum's tangent,
        # K[i]' = Horner's at the kernel's argument Z[i - 1].
        a = np.asarray(cfg.a, dtype=np.float64)
        tks = [tf0]
        for i in range(1, len(a)):
            w = _weights(a[i, :i], K)
            tz = _combine_tangent(ty, tks, tsafe_dt, safe_dt, K[:i], w)
            tks.append(_poly_tangent(Z[i - 1], tz, cs))
        tK = None
        if any(t is not None for t in tks):
            tK = torch.stack([_or_zeros(t, y) for t in tks])
        if cfg.fsal:
            f1, tf1 = K[-1], tks[-1]
        else:  # the trailing evaluation f1 = poly(y1)
            f1 = _poly_value(y1, cs)
            ty1 = _update_tangents(ty, tK, tsafe_dt, safe_dt, K, (cfg.b_sol,))[0]
            tf1 = _poly_tangent(y1, ty1, cs)
        return (*_step_tangents(cfg, y, ty, K, tK, f1, tf1, None, tks[0], tt, tt_new, safe_dt,
                                tsafe_dt, dt_cur, tdt_cur, pi1, tpi1, pi2, tpi2, running, None,
                                atol, tatol, rtol, trtol, y1, err, ratio, accept)[:-1],
                None, None, None)


# ------------------------------------------------------------- the events


class MaskedBisectRefine(torch.autograd.Function):
    """``ref.masked_bisect_refine``: the gradient flows through the ``where``
    selects of the bracket and the Horner sum at the new midpoint; the sign
    choice carries none.  The coefficients come last, as varargs."""

    @staticmethod
    def forward(lo, hi, v_lo, v_mid, active, *coeffs):
        return cuda_impl.masked_bisect_refine(coeffs, lo, hi, v_lo, v_mid, active)

    @staticmethod
    def setup_context(ctx, inputs, output):
        lo, hi, v_lo, v_mid, active, *coeffs = inputs
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(v_lo, v_mid, active, output[3], *coeffs)
        _save_for_jvp(ctx, inputs, output, v_lo, v_mid, active, output[3], *coeffs)

    @staticmethod
    def backward(ctx, g_lo, g_hi, g_vlo, g_mid, g_y):
        v_lo, v_mid, active, mid_new, *coeffs = ctx.saved_tensors
        need_c = ctx.needs_input_grad[5:]
        left = (torch.sign(v_lo) != torch.sign(v_mid)) | torch.isnan(v_lo) | torch.isnan(v_mid)
        m_hi, m_lo = active & left, active & ~left
        gc = [None] * len(coeffs)
        if g_y is not None:
            gx, gc = _horner_grads(g_y, mid_new[:, None], coeffs, lambda t: t, need_c, True)
            g_mid = _add(g_mid, gx[:, 0])
        if g_mid is not None:  # mid' = 0.5 * (lo' + hi')
            half = g_mid * 0.5
            g_lo, g_hi = _add(g_lo, half), _add(g_hi, half)
        g_m_hi, g_hi = _split(m_hi, g_hi)
        g_m_lo, g_lo = _split(m_lo, g_lo)
        g_vmid, g_vlo = _split(m_lo, g_vlo)
        g_m = _add(g_m_hi, g_m_lo)
        if g_m is not None:  # mid = 0.5 * (lo + hi)
            half = g_m * 0.5
            g_lo, g_hi = _add(g_lo, half), _add(g_hi, half)
        return g_lo, g_hi, g_vlo, g_vmid, None, *gc

    @_jvp
    def jvp(ctx, saved, tlo, thi, tv_lo, tv_mid, _tactive, *tc):
        v_lo, v_mid, active, mid_new, *coeffs = saved
        left = (torch.sign(v_lo) != torch.sign(v_mid)) | torch.isnan(v_lo) | torch.isnan(v_mid)
        m_hi, m_lo = active & left, active & ~left
        tmid = None if tlo is None and thi is None else _add(tlo, thi) * 0.5
        thi_new = _where(m_hi, tmid, thi)
        tlo_new = _where(m_lo, tmid, tlo)
        tv_lo_new = _where(m_lo, tv_mid, tv_lo)
        tmid_new = (None if tlo_new is None and thi_new is None
                    else _add(tlo_new, thi_new) * 0.5)
        xe = mid_new[:, None]
        txe = None if tmid_new is None else tmid_new[:, None]
        acc, tacc = coeffs[-1], tc[-1]
        for c, t in zip(coeffs[-2::-1], tc[-2::-1]):  # acc * xe + c, Horner's jvp
            tacc = _add(_add(None if txe is None else txe * acc,
                             None if tacc is None else tacc * xe), t)
            acc = acc * xe + c
        return tlo_new, thi_new, tv_lo_new, tmid_new, tacc


class FusedEventDetect(torch.autograd.Function):
    """``ref.fused_event_detect``: ``newly`` is non-differentiable, the
    carried values a ``where`` on ``accept``."""

    @staticmethod
    def forward(v_prev, v_new, fired, accept, directions):
        return cuda_impl.fused_event_detect(v_prev, v_new, fired, accept, directions=directions)

    @staticmethod
    def setup_context(ctx, inputs, output):
        accept = inputs[3]
        ctx.mark_non_differentiable(output[0])
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(accept)
        _save_for_jvp(ctx, inputs, output, accept)

    @staticmethod
    def backward(ctx, _g_newly, g_keep):
        (accept,) = ctx.saved_tensors
        g_new, g_prev = _split(accept[:, None], g_keep)
        return g_prev, g_new, None, None, None

    @_jvp
    def jvp(ctx, saved, tv_prev, tv_new, _tfired, _taccept, _tdirections):
        (accept,) = saved
        return None, _where(accept[:, None], tv_new, tv_prev)


class FusedEventCommit(torch.autograd.Function):
    """``ref.fused_event_commit``, writing into a copy of ``ev_y``.  The
    gradient flows to x, y_ev, y_new, t0, dt, ev_t and ev_y; ``fired'``,
    ``stop`` and ``n_new`` are non-differentiable.  The terminal resolution
    (which crossing each row stops at) is recomputed from x and newly."""

    @staticmethod
    def forward(x, y_ev, y_new, t0, dt, ev_t, ev_y, newly, fired, terminal):
        return cuda_impl.fused_event_commit(x, y_ev, newly, y_new, t0, dt, fired, ev_t,
                                            ev_y.clone(), terminal=terminal)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, y_ev, y_new, t0, dt, ev_t, ev_y, newly, fired, terminal = inputs
        fired_out, _, _, stop, _, _, n_new = output
        ctx.mark_non_differentiable(fired_out, stop, n_new)
        ctx.set_materialize_grads(False)
        ctx.terminal = terminal
        ctx.save_for_backward(x, newly, dt, stop)
        _save_for_jvp(ctx, inputs, output, x, newly, dt, stop)

    @staticmethod
    def backward(ctx, _g_fired, g_evt, g_evy, _g_stop, g_tstop, g_ystop, _g_n):
        x, newly, dt, stop = ctx.saved_tensors
        b, E = x.shape
        x_stop = torch.full((b,), torch.inf, dtype=x.dtype, device=x.device)
        winner = torch.full((b,), -1, dtype=torch.int64, device=x.device)
        for i, term in enumerate(ctx.terminal):
            if term:
                earlier = newly[:, i] & (x[:, i] < x_stop)
                x_stop = torch.where(earlier, x[:, i], x_stop)
                winner = torch.where(earlier, i, winner)
        rec = newly & (x <= x_stop[:, None])
        gx = gyev = gynew = gt0 = gdt = None
        g_tev, g_evt = _split(rec, g_evt)
        if g_tev is not None:  # t_ev = t0[:, None] + x * dt[:, None]
            gt0 = g_tev.sum(1)
            gx = g_tev * dt[:, None]
            gdt = (g_tev * x).sum(1)
        gyev, g_evy = _split(rec[:, :, None], g_evy)
        won = winner[:, None] == torch.arange(E, device=x.device)
        if g_tstop is not None:  # t_stop = t0 + where(stop, x_stop, 0) * dt
            gt0 = _add(gt0, g_tstop)
            gdt = _add(gdt, g_tstop * torch.where(stop, x_stop, 0.0))
            g_xstop = torch.where(stop, g_tstop * dt, 0.0)
            gx = _add(gx, torch.where(won, g_xstop[:, None], 0.0))
        if g_ystop is not None:
            gyev = _add(gyev, torch.where(won[:, :, None], g_ystop[:, None, :], 0.0))
            gynew = torch.where((winner >= 0)[:, None], 0.0, g_ystop)
        return gx, gyev, gynew, gt0, gdt, g_evt, g_evy, None, None, None

    @_jvp
    def jvp(ctx, saved, tx, ty_ev, ty_new, tt0, tdt, tev_t, tev_y, *_):
        x, newly, dt, stop = saved
        b = x.shape[0]
        x_stop = torch.full((b,), torch.inf, dtype=x.dtype, device=x.device)
        tx_stop, ty_stop = None, ty_new
        for i, term in enumerate(ctx.terminal):
            if term:
                earlier = newly[:, i] & (x[:, i] < x_stop)
                ty_stop = _where(earlier[:, None], None if ty_ev is None else ty_ev[:, i],
                                 ty_stop)
                tx_stop = _where(earlier, None if tx is None else tx[:, i], tx_stop)
                x_stop = torch.where(earlier, x[:, i], x_stop)
        rec = newly & (x <= x_stop[:, None])
        # t_ev = t0[:, None] + x * dt[:, None]
        tt_ev = _add(None if tt0 is None else tt0[:, None],
                     _add(None if tdt is None else tdt[:, None] * x,
                          None if tx is None else tx * dt[:, None]))
        # t_stop = t0 + where(stop, x_stop, 0) * dt
        tt_stop = _add(tt0, _add(None if tdt is None else tdt * torch.where(stop, x_stop, 0.0),
                                 None if tx_stop is None
                                 else torch.where(stop, tx_stop, 0.0) * dt))
        return (None, _where(rec, tt_ev, tev_t), _where(rec[:, :, None], ty_ev, tev_y), None,
                tt_stop, ty_stop, None)


# --------------------------------------------------------- the stiff path


def _lu_grad(g, lu, perm):
    """torch's ``lu_factor_ex`` backward (``linalg_lu_backward``, square
    case) on the factors ``A[perm] = L U``: ``P L^{-H} (L^H g o 1_L + g U^H
    o 1_U) U^{-H}``, P the permutation matrix of ``perm``."""
    f = lu.shape[-1]
    L = torch.tril(lu, -1) + torch.eye(f, dtype=lu.dtype, device=lu.device)
    U = torch.triu(lu)
    X = L.mT.matmul(g).tril(-1) + g.matmul(U.mT).triu()
    X = torch.linalg.solve_triangular(U.mT, X, upper=False, left=False)
    X = torch.linalg.solve_triangular(L.mT, X, upper=True, left=True, unitriangular=True)
    # P[perm[i], i] = 1; as a product, so that a NaN spreads as it does there.
    P = torch.zeros_like(lu).scatter_(1, perm.long()[:, None, :], 1.0)
    return P.matmul(X)


def _lu_tangent(tA, lu, perm):
    """torch's ``lu_factor_ex`` jvp (square case) on the factors ``A[perm] =
    L U``: with ``phi = L^{-1} (P^T A') U^{-1}``, ``L' = L tril(phi, -1)``
    and ``U' = triu(phi) U``, packed as the factors are."""
    f = lu.shape[-1]
    L = torch.tril(lu, -1) + torch.eye(f, dtype=lu.dtype, device=lu.device)
    U = torch.triu(lu)
    idx = perm.long()[:, :, None].expand(-1, -1, f)
    phi = torch.linalg.solve_triangular(L, torch.gather(tA, 1, idx), upper=False,
                                        unitriangular=True)
    phi = torch.linalg.solve_triangular(U, phi, upper=True, left=False)
    return L.matmul(phi.tril(-1)) + phi.triu().matmul(U)


_FACTOR_SPLIT: list = []  # [(weakref to lu, weakref to tlu, their versions, the split)]


def _drop_factor_split(ref_lu):
    if _FACTOR_SPLIT and _FACTOR_SPLIT[0][0] is ref_lu:
        _FACTOR_SPLIT.clear()


def _factor_split(lu, tlu):
    """``(L - I, L', U')`` of the packed factors ``A[perm] = L U`` and
    their tangent ``tlu`` (packed as they are).  The
    chord Newton iterations of a step all take one factorisation and its
    tangent, so the last pair's split is kept while both tensors live and
    are unchanged (their version counters), and formed anew otherwise."""
    versions = (lu._version, tlu._version)
    if _FACTOR_SPLIT:
        ref_lu, ref_tlu, seen, split = _FACTOR_SPLIT[0]
        if ref_lu() is lu and ref_tlu() is tlu and seen == versions:
            return split
    split = (torch.tril(lu, -1), torch.tril(tlu, -1), torch.triu(tlu))
    _FACTOR_SPLIT[:] = [(weakref.ref(lu, _drop_factor_split), weakref.ref(tlu), versions, split)]
    return split


class BatchedLUFactor(torch.autograd.Function):
    """``ref.batched_lu_factor``: the packed LU's gradient to A; ``perm`` is
    non-differentiable."""

    @staticmethod
    def forward(A):
        return cuda_impl.batched_lu_factor(A)

    @staticmethod
    def setup_context(ctx, inputs, output):
        lu, perm = output
        ctx.mark_non_differentiable(perm)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(lu, perm)
        _save_for_jvp(ctx, inputs, output, lu, perm)

    @staticmethod
    def backward(ctx, g, _g_perm):
        if g is None:
            return None
        lu, perm = ctx.saved_tensors
        return _lu_grad(g, lu, perm)

    @_jvp
    def jvp(ctx, saved, tA):
        lu, perm = saved
        return (None if tA is None else _lu_tangent(tA, lu, perm)), None


class BatchedLinsolve(torch.autograd.Function):
    """``ref.batched_linsolve``: x with A x = rhs.  Saves A by reference and
    x, no factor; the backward solves with A^T once, the jvp launches the
    kernel once more on the same A: x' = A^{-1} (rhs' - A' x)."""

    @staticmethod
    def forward(A, rhs):
        return cuda_impl.batched_linsolve(A, rhs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)
        _save_for_jvp(ctx, inputs, output, inputs[0], output)

    @staticmethod
    def backward(ctx, g):
        A, x = ctx.saved_tensors
        need_A, need_rhs = ctx.needs_input_grad
        g_rhs = torch.linalg.solve(A.mT, g)
        g_A = -(g_rhs[:, :, None] * x[:, None, :]) if need_A else None
        return g_A, (g_rhs if need_rhs else None)

    @_jvp
    def jvp(ctx, saved, tA, trhs):
        A, x = saved
        rhs = _add(trhs, None if tA is None else -torch.matmul(tA, x[:, :, None])[:, :, 0])
        return None if rhs is None else cuda_impl.batched_linsolve(A, rhs.contiguous())


def _commit_grads(g_k, g_res, delta, scale, active, out, need_scale):
    """``ref._masked_commit``: ``where(active, k - delta, k)`` and the RMS of
    ``delta / scale``.  Returns the gradients in (k, delta, scale)."""
    gk = gdelta = gscale = None
    if g_k is not None:
        g_sub, gk = _split(active[:, None], g_k)
        gk, gdelta = gk + g_sub, -g_sub
    if g_res is not None:
        gnum, gsc = _rms_grads(g_res, delta, scale, out, need_scale)
        gdelta = _add(gdelta, gnum)
        if gsc is not None:
            gscale = gsc.sum_to_size(scale.shape)
    return gk, gdelta, gscale


class MaskedNewtonUpdate(torch.autograd.Function):
    """``ref.masked_newton_update``: the gradient flows into k, delta and
    scale; ``active`` is a mask.  The tangent of k is the kernel on (k',
    delta'); the residual's is plain torch."""

    @staticmethod
    def forward(k, delta, scale, active):
        return cuda_impl.masked_newton_update(k, delta, active, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        k, delta, scale, active = inputs
        res = output[1]
        ctx.set_materialize_grads(False)
        ctx.scale_number = None if isinstance(scale, torch.Tensor) else scale
        scale_t = (scale,) if ctx.scale_number is None else ()
        ctx.save_for_backward(delta, active, res, *scale_t)
        _save_for_jvp(ctx, inputs, output, delta, active, res, *scale_t)

    @staticmethod
    def backward(ctx, g_k, g_res):
        delta, active, res, *scale = ctx.saved_tensors
        scale = scale[0] if scale else ctx.scale_number
        need_k, need_delta, need_scale, _ = ctx.needs_input_grad
        gk, gdelta, gscale = _commit_grads(g_k, g_res, delta, scale, active, res, need_scale)
        return (gk if need_k else None), (gdelta if need_delta else None), gscale, None

    @_jvp
    def jvp(ctx, saved, tk, tdelta, tscale, _tactive):
        delta, active, res, *scale = saved
        scale = scale[0] if scale else ctx.scale_number
        tk_new = tk
        if tdelta is not None:
            tk_new = cuda_impl.masked_newton_update(_or_zeros(tk, delta), tdelta.contiguous(),
                                                    active, scale)[0]
        return _fresh(tk_new, tk), _rms_tangent(delta, tdelta, scale, tscale, res)


class FusedNewtonIter(torch.autograd.Function):
    """``ref.fused_newton_iter``: ``delta = U^{-1} L^{-1} (k - fk)[perm]``,
    then the masked commit.  The gradient flows into lu (through both
    substitutions), k, fk and scale; ``perm`` and ``active`` are not
    differentiated.  delta is recomputed from the saved factors.  The
    tangent: ``delta' = (LU)^{-1} ((k' - fk')[perm] - (L' U + L U') delta)``
    by one launch of the kernel on every row (k = 0, so its k' is
    ``-delta'`` exactly); the factors' term in plain torch, by products
    with ``_factor_split``'s triangles, formed once a factorisation.  delta
    and x2 come from the plain op's substitutions, not from the kernel:
    the residual norm's tangent sums delta times delta', and held against
    the plain op's jvp in float32 it must carry the plain op's rounding of
    delta (the kernel's, on the chord matrices at f = 128, moved it 13.6x
    past the card's rule)."""

    @staticmethod
    def forward(lu, k, fk, scale, perm, active):
        return cuda_impl.fused_newton_iter(lu, perm, k, fk, active, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        lu, k, fk, scale, perm, active = inputs
        res = output[1]
        ctx.set_materialize_grads(False)
        ctx.scale_number = None if isinstance(scale, torch.Tensor) else scale
        scale_t = (scale,) if ctx.scale_number is None else ()
        ctx.save_for_backward(lu, k, fk, perm, active, res, *scale_t)
        _save_for_jvp(ctx, inputs, output, lu, k, fk, perm, active, res, *scale_t)

    @staticmethod
    def backward(ctx, g_k, g_res):
        lu, k, fk, perm, active, res, *scale = ctx.saved_tensors
        scale = scale[0] if scale else ctx.scale_number
        need_lu, need_k, need_fk, need_scale, _, _ = ctx.needs_input_grad
        idx = perm.long()
        x1 = torch.gather(k - fk, 1, idx)[..., None]
        x2 = torch.linalg.solve_triangular(lu, x1, upper=False, unitriangular=True)
        delta = torch.linalg.solve_triangular(lu, x2, upper=True)
        gk, gdelta, gscale = _commit_grads(g_k, g_res, delta[..., 0], scale, active, res,
                                           need_scale)
        glu = gfk = None
        if gdelta is not None:
            # solve_triangular's backward: g_B = A^{-H} g, g_A = -g_B X^H on A's triangle.
            gb_u = torch.linalg.solve_triangular(lu.mT, gdelta[..., None], upper=False)
            gb_l = torch.linalg.solve_triangular(lu.mT, gb_u, upper=True, unitriangular=True)
            if need_lu:
                glu = (-gb_l.matmul(x2.mT)).tril(-1) + (-gb_u.matmul(delta.mT)).triu()
            g_r = torch.zeros_like(k).scatter_add_(1, idx, gb_l[..., 0])
            gk, gfk = _add(gk, g_r), -g_r
        return (glu, (gk if need_k else None), (gfk if need_fk else None), gscale, None, None)

    @_jvp
    def jvp(ctx, saved, tlu, tk, tfk, tscale, _tperm, _tactive):
        lu, k, fk, perm, active, res, *scale = saved
        scale = scale[0] if scale else ctx.scale_number
        idx = perm.long()
        x2 = torch.linalg.solve_triangular(lu, torch.gather(k - fk, 1, idx)[..., None],
                                           upper=False, unitriangular=True)
        delta = torch.linalg.solve_triangular(lu, x2, upper=True)
        r = _add(tk, None if tfk is None else -tfk)  # (k - fk)'
        if tlu is not None:  # (L' U + L U') delta, in the permuted rows
            lower, t_lower, t_upper = _factor_split(lu, tlu)
            u = t_upper.matmul(delta)
            q = t_lower.matmul(x2) + lower.matmul(u) + u  # L's unit diagonal
            r = _add(r, -torch.zeros_like(k).scatter_(1, idx, q[..., 0]))
        tdelta = None
        if r is not None:
            tdelta = -cuda_impl.fused_newton_iter(lu, perm, torch.zeros_like(k),
                                                  (-r).contiguous(), torch.ones_like(active),
                                                  scale)[0]
        tk_new = _where(active[:, None], _add(tk, None if tdelta is None else -tdelta), tk)
        return tk_new, _rms_tangent(delta[..., 0], tdelta, scale, tscale, res)


# ------------------------------------------------------------ the attention


class FlashAttention(torch.autograd.Function):
    """GQA flash attention with its backward.  On the card the forward is
    ``cuda_impl.flash_attention_fwd(..., lse=True)`` and the backward the
    CUDA ``flash_attention_bwd``; on the CPU the plain pair
    (``ref.flash_attention_fwd`` / ``ref.flash_attention_bwd``, at the
    caller's chunks).  Saves q, k, v, the output and its row log-sum-exp:
    the scores are recomputed in the backward, never stored."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, q_chunk, kv_chunk):
        ctx.kw = dict(causal=causal, q_offset=q_offset)
        if q.device.type == "cuda":
            o, lse = cuda_impl.flash_attention_fwd(q, k, v, lse=True, **ctx.kw)
        else:
            ctx.kw.update(q_chunk=q_chunk, kv_chunk=kv_chunk)
            o, lse = ref.flash_attention_fwd(q, k, v, lse=True, **ctx.kw)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = cuda_impl.flash_attention_bwd if q.device.type == "cuda" else ref.flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, o, lse, do.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None, None


# ------------------------------------------------------------ entry points


def stage_accum(y, dt, K, coeffs):
    return StageAccum.apply(y, dt, K, coeffs)


def fused_update(y, K, dt, b_sol, b_err):
    return FusedUpdate.apply(y, K, dt, b_sol, b_err)


def error_norm(err, y0, y1, atol, rtol):
    return ErrorNorm.apply(err, y0, y1, atol, rtol)


def interp_eval(coeffs, x, mask, out, cursor=None):
    return InterpEval.apply(x, mask, out, cursor, *coeffs)


def _coeff_outs(coeffs, y):
    """The Hermite coefficients as a fused step Function returns them: c0
    (the input y) as a copy of y, so that its cotangent meets the others in
    the backward's order (an input returned as-is could not be saved, and a
    view of a view would not take a tangent); four Nones without
    coefficients."""
    if coeffs is None:
        return (None,) * 4
    return (y.clone(), *coeffs[1:])


def _step_out(res, want_coeffs):
    """A fused step Function's outputs as ``ref.fused_step`` returns them
    (the buffers it writes out for its backward dropped)."""
    return (*res[:9], tuple(res[9:13]) if want_coeffs else None)


def fused_step(y, K, f1, t, t_new, dt_cur, safe_dt, running, prev_inv, prev2_inv, atol, rtol,
               *, b_sol, b_err, ctrl, want_coeffs, ctrl_mode="pid", failed=None, f0=None):
    cfg = _StepConfig(tuple(np.asarray(b_sol, np.float64).tolist()),
                      tuple(np.asarray(b_err, np.float64).tolist()), tuple(ctrl),
                      bool(want_coeffs), ctrl_mode)
    res = FusedStep.apply(y, K, f1, t, t_new, dt_cur, safe_dt, running, prev_inv, prev2_inv,
                          atol, rtol, failed, f0, cfg)
    return _step_out(res, want_coeffs)


def fused_step_poly(y, f0, t, t_new, dt_cur, safe_dt, running, prev_inv, prev2_inv, atol, rtol,
                    *, a, c, b_sol, b_err, poly, ctrl, want_coeffs, fsal=True, ctrl_mode="pid"):
    del c  # autonomous polynomial dynamics
    cfg = _StepConfig(tuple(np.asarray(b_sol, np.float64).tolist()),
                      tuple(np.asarray(b_err, np.float64).tolist()), tuple(ctrl),
                      bool(want_coeffs), ctrl_mode, np.asarray(a, np.float64), tuple(poly),
                      bool(fsal))
    res = FusedStepPoly.apply(y, f0, t, t_new, dt_cur, safe_dt, running, prev_inv, prev2_inv,
                              atol, rtol, cfg)
    return _step_out(res, want_coeffs)


def masked_bisect_refine(coeffs, lo, hi, v_lo, v_mid, active):
    return MaskedBisectRefine.apply(lo, hi, v_lo, v_mid, active, *coeffs)


def fused_event_detect(v_prev, v_new, fired, accept, *, directions):
    return FusedEventDetect.apply(v_prev, v_new, fired, accept, tuple(directions))


def fused_event_commit(x, y_ev, newly, y_new, t0, dt, fired, ev_t, ev_y, *, terminal):
    return FusedEventCommit.apply(x, y_ev, y_new, t0, dt, ev_t, ev_y, newly, fired,
                                  tuple(terminal))


def batched_lu_factor(A):
    return BatchedLUFactor.apply(A)


def batched_linsolve(A, rhs):
    return BatchedLinsolve.apply(A, rhs)


def fused_newton_iter(lu, perm, k, fk, active, scale):
    return FusedNewtonIter.apply(lu, k, fk, scale, perm, active)


def masked_newton_update(k, delta, active, scale):
    return MaskedNewtonUpdate.apply(k, delta, scale, active)


def flash_attention(q, k, v, *, causal=True, q_offset=0, q_chunk=256, kv_chunk=128):
    return FlashAttention.apply(q, k, v, causal, q_offset, q_chunk, kv_chunk)
