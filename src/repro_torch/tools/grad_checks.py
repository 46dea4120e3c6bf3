"""The inputs and the comparison rule of the four backwards of
``kernels/autograd.py`` (``stage_accum``, ``fused_update``, ``error_norm``,
``interp_eval``), shared by ``tests/test_torch_grad.py`` (the Functions on
the CPU, their kernels stood in by the plain ops), the card tests and
``chip_smoke.py``.

A case is a dict of numpy inputs made from a seed and the cotangents of the
op's outputs.  ``case_grads(case, fn, device)`` runs ``fn`` -- the plain op
or the Function -- on fresh tensors that require grad and returns
``torch.autograd.grad`` of the outputs against the cotangents, for every
differentiable input (``DIFF``).  ``hold`` is the rule: the same non-finite
entries (a row whose error ratio is 0 has a NaN gradient, as autograd of the
plain op gives it), and every other entry within ``step_checks.tolerance``
(1e-5 float32, 1e-12 float64) relative and absolute -- the two backwards
compute the same expressions, and the Function's ``error_norm`` divides by
the kernel's ratio, which carries the forward's rounding.

The cases at one shape: ``stage_accum`` at j = 1, 3, 6 stages; ``fused_update``
with dopri5's weights and with random weights at s = 4; ``error_norm`` at
each tolerance shape, with a row whose error is zero, a row where |y0| ==
|y1| (the tie ``maximum`` splits) and zeros in y0 (``abs'(0) = 0``);
``interp_eval`` at each mask kind, and on a window of 4 points.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import autograd, ref
from .dense_checks import MASK_KINDS, TOL_KINDS, interp_inputs, norm_inputs
from .step_checks import tolerance

OPS = ("stage_accum", "fused_update", "error_norm", "interp_eval")
# The differentiable inputs of each op, by position in the op's arguments.
DIFF = {"stage_accum": ("y", "dt", "K"), "fused_update": ("y", "K", "dt"),
        "error_norm": ("err", "y0", "y1"), "interp_eval": ("coeffs", "x", "out")}
# Tableau constants: numpy, taken by value, never differentiated.
CONSTS = {"stage_accum": ("coeffs",), "fused_update": ("b_sol", "b_err")}
STAGES = (1, 3, 6)
WINDOW = 4


def _dopri5_weights():
    from ..core.tableau import get_tableau

    tab = get_tableau("dopri5")
    return np.asarray(tab.b_sol, np.float64), np.asarray(tab.b_err, np.float64)


def cases(b, f, n, dtype, seed=0, tol_kinds=TOL_KINDS, mask_kinds=MASK_KINDS):
    """Every case at one (b, f) and n eval points, numpy ``dtype``."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(dtype)

    out = []
    y, dt, K = r(b, f), rng.uniform(-0.5, 0.5, b).astype(dtype), r(7, b, f)
    a = rng.standard_normal(7)
    for j in STAGES:
        out.append(dict(op="stage_accum", label=f"j={j}", args=dict(
            y=y, dt=dt, K=K[:j], coeffs=a[:j]), cot=(r(b, f),)))
    for label, (bs, be) in (("dopri5", _dopri5_weights()),
                            ("s=4", (rng.standard_normal(4), rng.standard_normal(4)))):
        out.append(dict(op="fused_update", label=label, args=dict(
            y=y, K=K[:len(bs)], dt=dt, b_sol=bs, b_err=be), cot=(r(b, f), r(b, f))))
    for i, kind in enumerate(tol_kinds):
        err, y0, y1, atol, rtol = norm_inputs(seed + 10 + i, b, f, dtype, kind)
        err[0] = 0.0  # ratio 0: autograd of the plain op gives 0 * inf
        if b > 1:
            y1[1] = -y0[1]  # |y0| == |y1|: maximum splits the gradient
        y0[-1, ::2] = 0.0  # abs'(0) = 0
        out.append(dict(op="error_norm", label=f"tol={kind}", args=dict(
            err=err, y0=y0, y1=y1, atol=atol, rtol=rtol), cot=(r(b),)))
    for i, kind in enumerate(mask_kinds):
        coeffs, x, mask, buf = interp_inputs(seed + 20 + i, b, n, f, dtype, kind)
        out.append(dict(op="interp_eval", label=f"mask={kind}", args=dict(
            coeffs=coeffs, x=x, mask=mask, out=buf, cursor=None), cot=(r(b, n, f),)))
    W = min(WINDOW, n)
    coeffs, x, mask, buf = interp_inputs(seed + 30, b, n, f, dtype, "all")
    cursor = rng.integers(0, n - W + 1, b)
    out.append(dict(op="interp_eval", label=f"window={W}", args=dict(
        coeffs=coeffs, x=x[:, :W].copy(), mask=np.asarray(rng.random((b, W)) < 0.5),
        out=buf, cursor=cursor), cot=(r(b, n, f),)))
    return out


def plain(op):
    """The plain op of ``ref.py``, with ``interp_eval``'s window form."""
    if op == "interp_eval":
        def interp(coeffs, x, mask, out, cursor):
            if cursor is None:
                return ref.interp_eval(coeffs, x, mask, out)
            return ref.interp_eval_window(coeffs, x, mask, out, cursor)
        return interp
    return getattr(ref, op)


def function(op):
    """The op's autograd Function (the kernel forward; ``autograd.py``)."""
    return getattr(autograd, op)


def _tensor(x, device, grad):
    if isinstance(x, tuple):
        return tuple(_tensor(c, device, grad) for c in x)
    if not isinstance(x, np.ndarray):
        return x
    t = torch.as_tensor(x, device=device)
    if t.dtype == torch.int64 or t.dtype == torch.bool:
        return t
    return t.requires_grad_(grad)


def _graph(case, fn, device):
    """``fn`` run on the case's inputs as fresh tensors: ``(args, outputs,
    cotangents, inputs)``, the inputs in ``DIFF`` order (the coefficient
    planes one by one)."""
    op = case["op"]
    args = {k: v if k in CONSTS.get(op, ()) else _tensor(v, device, k in DIFF[op])
            for k, v in case["args"].items()}
    outs = fn(**args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    cots = [torch.as_tensor(c, device=device) for c in case["cot"]]
    inputs = [t for k in DIFF[op] for t in (args[k] if isinstance(args[k], tuple) else (args[k],))]
    return args, outs, cots, inputs


def case_grads(case, fn, device):
    """``torch.autograd.grad`` of ``fn(**case["args"])`` against the case's
    cotangents, for each differentiable input: a dict name -> tensor (a
    tuple for the coefficients), None where the input does not reach the
    outputs."""
    args, outs, cots, inputs = _graph(case, fn, device)
    grads = list(torch.autograd.grad(outs, inputs, cots, allow_unused=True))
    res = {}
    for k in DIFF[case["op"]]:
        if isinstance(args[k], tuple):
            res[k] = tuple(grads.pop(0) for _ in args[k])
        else:
            res[k] = grads.pop(0)
    return res


def time_backward(case, device, median_ms):
    """The backward pass alone -- ``torch.autograd.grad`` over a graph built
    once and kept -- of the Function and of the plain op on the case's
    inputs, timed by ``median_ms``: ``{"function": ms, "plain": ms}``."""
    res = {}
    for label, fn in (("function", function(case["op"])), ("plain", plain(case["op"]))):
        _, outs, cots, inputs = _graph(case, fn, device)
        res[label] = median_ms(lambda: torch.autograd.grad(outs, inputs, cots, retain_graph=True,
                                                           allow_unused=True))
    return res


def hold(name, got, want, dtype):
    """The rule (see the module docstring).  Returns the largest absolute
    difference over the finite entries; raises AssertionError otherwise."""
    tol = tolerance(dtype)
    worst = 0.0
    for k in want:
        pairs = (zip(got[k], want[k]) if isinstance(want[k], tuple) else ((got[k], want[k]),))
        for g, w in pairs:
            if w is None or g is None:
                assert g is None and w is None, f"{name}: d/d{k} is None on one side only"
                continue
            torch.testing.assert_close(g, w, rtol=tol, atol=tol, equal_nan=True,
                                       msg=lambda m, k=k: f"{name}: d/d{k}: {m}")
            fin = torch.isfinite(w)
            if bool(fin.any()):
                worst = max(worst, float((g - w)[fin].abs().max()))
    return worst


CARD_VS_CPU = 1e-9  # float64 gradients, card against CPU, relative to the largest


def train_grads(device, driver="scan", mode="joint", rows=None, checkpoint_every=0):
    """One forward and backward of ``workloads.full_width_train``'s reduced
    float64 twin on ``device``: ``(loss, grads, n_steps)``, ``grads`` the
    numpy gradients of y0 and of every weight (``w1, b1, w2, b2``).
    ``driver="scan"``: ``ScanAdjoint`` with dense output, the MSE against
    the target trajectory (``n_steps`` per row); ``"backsolve"``:
    ``BacksolveAdjoint(mode=mode)``, the MSE of the final state against the
    target's last point (``n_steps`` None)."""
    from ..core import BacksolveAdjoint, ScanAdjoint
    from . import workloads

    vf, y0, te, kw, target = workloads.full_width_train(device, reduced=True)
    if rows is not None:
        y0, target = y0[:rows], target[:rows]
    y0 = torch.as_tensor(y0, device=device).requires_grad_()
    weights = kw["args"]
    tols = dict(rtol=kw["rtol"], atol=kw["atol"])
    if driver == "scan":
        sol = ScanAdjoint(max_steps=workloads.TRAIN["max_steps"],
                          checkpoint_every=checkpoint_every, **tols).solve(
            vf, y0, te, args=weights, device=device)
        loss, steps = workloads.mse(sol.ys, target), sol.stats["n_steps"].cpu().numpy()
    else:
        y1 = BacksolveAdjoint(mode=mode, **tols).solve(
            vf, y0, t_start=float(te[0]), t_end=float(te[-1]), args=weights, device=device)
        loss, steps = workloads.mse(y1, target[:, -1]), None
    grads = torch.autograd.grad(loss, [y0, *weights.values()])
    return float(loss.detach()), [g.detach().cpu().numpy() for g in grads], steps


def hold_card_to_cpu(name, card, cpu):
    """The card's ``train_grads`` against the CPU's: equal step counts and
    every gradient within ``CARD_VS_CPU`` of the CPU's, relative to the
    CPU gradient's largest entry.  Returns the largest relative difference."""
    if cpu[2] is not None:
        assert np.array_equal(card[2], cpu[2]), f"{name}: step counts {card[2]} != {cpu[2]}"
    worst = 0.0
    for g, w in zip(card[1], cpu[1]):
        assert np.isfinite(g).all(), f"{name}: a card gradient is not finite"
        worst = max(worst, float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-300)))
    assert worst <= CARD_VS_CPU, f"{name}: card gradients differ by {worst} relative"
    return worst
