"""The inputs and the comparison rule of the thirteen backwards of
``kernels/autograd.py`` (the explicit path's ``stage_accum``,
``fused_update``, ``error_norm``, ``interp_eval``; ``fused_step``,
``fused_step_poly``; the event ops ``masked_bisect_refine``,
``fused_event_detect``, ``fused_event_commit``; the stiff path's
``batched_lu_factor``, ``batched_linsolve``, ``fused_newton_iter``,
``masked_newton_update``), shared by ``tests/test_torch_grad.py`` and
``tests/test_torch_grad_paths.py`` (the Functions on the CPU, their kernels
stood in by the plain ops: ``stand_in``), the card tests and
``chip_smoke.py``.

A case is a dict of numpy inputs made from a seed and the cotangents of the
op's floating outputs, in order (nested tuples flattened; ``fused_step``'s
c0, the input y itself, included; None leaves an output out).  ``case_grads(case, fn, device)`` runs
``fn`` -- the plain op or the Function -- on fresh tensors that require
grad and returns ``torch.autograd.grad`` of the outputs against the
cotangents, for every differentiable input (``DIFF``; a tolerance only where
the case gives it as an array).  ``hold`` is the rule, entry by entry: the
same non-finite entries (a row whose error ratio is 0 has a NaN gradient, as autograd of the
plain op gives it), and every other entry within ``step_checks.tolerance``
(1e-5 float32, 1e-12 float64) relative and absolute -- the two backwards
compute the same expressions, and the Functions divide by the kernel's
ratios and norms, which carry the forward's rounding.  On the card the
nine backwards of the fused, event and stiff paths are held to
``card_plain`` by ``hold_on_card``.

The cases at one shape (``ops=`` picks the ops): ``stage_accum`` at j = 1,
3, 6 stages; ``fused_update`` with dopri5's weights and with random weights
at s = 4; ``error_norm`` at each tolerance shape, with a row whose error is
zero, a row where |y0| == |y1| (the tie ``maximum`` splits) and zeros in y0
(``abs'(0) = 0``); ``interp_eval`` at each mask kind, and on a window of 4
points.  ``fused_step`` with dopri5 and the PID filter (scalar tolerances,
the coefficients; rows not running, rejected, clamped at ``dt_max`` and a
row of zero step, whose ratio is 0), with kvaerno5's weights, ``failed``
rows and ``f0`` under (b, f) and (b,) tolerances, and under the fixed
controller; ``fused_step_poly`` with dopri5 (FSAL) and rk4 (a trailing
evaluation) on the logistic and a per-feature cubic.  The event ops on
``event_checks``' inputs: ``masked_bisect_refine`` with mixed, all and no
rows active (condition values of both signs, zeros and NaNs),
``fused_event_detect`` with every direction, ``fused_event_commit`` with
mixed, all and no terminal events over its row classes (no crossing, one,
all tied).  The stiff ops on ``newton_checks``' chord matrices: shuffled
rows (distinct pivots), a zero leading diagonal and tied pivots (f >= 3),
with mixed, all and no rows active.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import autograd, cuda_impl, ref
from .dense_checks import MASK_KINDS, TOL_KINDS, interp_inputs, norm_inputs
from .event_checks import bisect_inputs, commit_inputs, detect_inputs
from .newton_checks import chord_matrices, newton_inputs
from .step_checks import tolerance

EXPLICIT = ("stage_accum", "fused_update", "error_norm", "interp_eval")
FUSED = ("fused_step", "fused_step_poly")
EVENTS = ("masked_bisect_refine", "fused_event_detect", "fused_event_commit")
STIFF = ("batched_lu_factor", "batched_linsolve", "fused_newton_iter", "masked_newton_update")
OPS = EXPLICIT + FUSED + EVENTS + STIFF
# The differentiable inputs of each op, by name in the op's arguments.
DIFF = {"stage_accum": ("y", "dt", "K"), "fused_update": ("y", "K", "dt"),
        "error_norm": ("err", "y0", "y1"), "interp_eval": ("coeffs", "x", "out"),
        "fused_step": ("y", "K", "f1", "t", "t_new", "dt_cur", "safe_dt", "prev_inv",
                       "prev2_inv", "atol", "rtol", "f0"),
        "fused_step_poly": ("y", "f0", "t", "t_new", "dt_cur", "safe_dt", "prev_inv",
                            "prev2_inv", "atol", "rtol"),
        "masked_bisect_refine": ("coeffs", "lo", "hi", "v_lo", "v_mid"),
        "fused_event_detect": ("v_prev", "v_new"),
        "fused_event_commit": ("x", "y_ev", "y_new", "t0", "dt", "ev_t", "ev_y"),
        "batched_lu_factor": ("A",), "batched_linsolve": ("A", "rhs"),
        "fused_newton_iter": ("lu", "k", "fk", "scale"),
        "masked_newton_update": ("k", "delta", "scale")}
# Static arguments: taken by value, never differentiated.
CONSTS = {"stage_accum": ("coeffs",), "fused_update": ("b_sol", "b_err"),
          "fused_step": ("b_sol", "b_err", "ctrl", "want_coeffs", "ctrl_mode"),
          "fused_step_poly": ("a", "c", "b_sol", "b_err", "poly", "ctrl", "want_coeffs", "fsal",
                              "ctrl_mode"),
          "fused_event_detect": ("directions",), "fused_event_commit": ("terminal",)}
STAGES = (1, 3, 6)
WINDOW = 4
EVENTS_E = 2  # full_width_long_events' two events
# dopri5's PID filter (pid_controller().filter_params(5)), and with dt_max
# low enough that rows clamp there.
PID = (0.12, -0.08, 0.02, 0.9, 0.2, 10.0, 0.0, float("inf"))
PID_CLAMPED = PID[:7] + (0.12,)
POLYS = {"logistic": (0.0, 1.0, -1.0), "cubic": (0.5, (-1.0, 0.5), 0.0, (-0.2, 0.1))}
POLY_TOLS = {"logistic": 1e-4, "cubic": 1e-3}


def _tableau(name):
    """(a, c, b_sol, b_err) of a tableau as the steppers hand them over."""
    from ..core.stepper import _tableau_arrays
    from ..core.tableau import get_tableau

    return _tableau_arrays(get_tableau(name), torch.float64)


def _dopri5_weights():
    return _tableau("dopri5")[2:]


def _step_cases(rng, b, f, dtype):
    """``fused_step`` and ``fused_step_poly`` (see the module docstring)."""
    def r(*shape):
        return rng.standard_normal(shape).astype(dtype)

    def u(lo, hi, *shape):
        return rng.uniform(lo, hi, shape).astype(dtype)

    def cols(dt_lo=0.05, dt_hi=0.2):
        t, dt_cur = u(0.0, 1.0, b), u(dt_lo, dt_hi, b)
        safe_dt = (0.9 * dt_cur).astype(dtype)
        safe_dt[0] = 0.0  # no step: err = 0, ratio 0, y1 == y (the tie)
        return dict(t=t, t_new=(t + safe_dt).astype(dtype), dt_cur=dt_cur, safe_dt=safe_dt,
                    running=rng.uniform(size=b) > 0.25, prev_inv=u(0.5, 2.0, b),
                    prev2_inv=u(0.5, 2.0, b))

    def cots(n_planes, ratio=True):  # y1, ratio, y_out, f_out, t_out, dt_out, inv, inv2, c0..c3
        return (r(b, f), r(b) if ratio else None, r(b, f), r(b, f), r(b), r(b), r(b), r(b),
                *(r(b, f) for _ in range(n_planes)))

    out = []
    _, _, bs, be = _tableau("dopri5")
    for label, ctrl in (("dopri5/pid", PID), ("dopri5/dt_max", PID_CLAMPED)):
        # About a third of the rows reject: err scales up with the row.
        y, K = r(b, f), r(7, b, f) * np.linspace(0.1, 40.0, b).astype(dtype)[:, None]
        out.append(dict(op="fused_step", label=label, args=dict(
            y=y, K=K, f1=K[-1].copy(), **cols(), atol=1e-3, rtol=1e-3, b_sol=bs, b_err=be,
            ctrl=ctrl, want_coeffs=True, ctrl_mode="pid", failed=None, f0=None),
            cot=cots(4)))
    _, _, bs, be = _tableau("kvaerno5")
    for label, tols in (("kvaerno5/failed/full_tol", (u(1e-4, 1e-3, b, f), u(1e-4, 1e-3, b, f))),
                        ("kvaerno5/failed/row_tol", (u(1e-4, 1e-3, b), u(1e-4, 1e-3, b)))):
        y, K = r(b, f), 0.05 * r(7, b, f)
        out.append(dict(op="fused_step", label=label, args=dict(
            y=y, K=K, f1=r(b, f), **cols(), atol=tols[0], rtol=tols[1], b_sol=bs, b_err=be,
            ctrl=PID, want_coeffs=False, ctrl_mode="pid", failed=rng.uniform(size=b) < 0.2,
            f0=r(b, f)), cot=cots(0)))
    # rk4 has no error estimate: its ratio is 0 in every row, and no loss
    # reads it (the fixed controller decides without it).
    _, _, bs, be = _tableau("rk4")
    y, K = r(b, f), r(4, b, f)
    out.append(dict(op="fused_step", label="rk4/fixed", args=dict(
        y=y, K=K, f1=r(b, f), **cols(), atol=1e-6, rtol=1e-3, b_sol=bs, b_err=be, ctrl=(),
        want_coeffs=True, ctrl_mode="fixed", failed=None, f0=None), cot=cots(4, ratio=False)))
    for method in ("dopri5", "rk4"):
        a, c, bs, be = _tableau(method)
        fsal = method == "dopri5"
        for poly in POLYS:
            if np.ndim(POLYS[poly][1]) and f != 2:
                continue  # per-feature coefficients are (2,)-long
            y = u(0.5, 1.5, b, f)
            coeffs = POLYS[poly]
            f0 = ref.poly_eval(torch.as_tensor(y), coeffs).numpy()
            kw = dict(a=a, c=c, b_sol=bs, b_err=be, poly=coeffs, ctrl=PID if fsal else (),
                      want_coeffs=True, fsal=fsal, ctrl_mode="pid" if fsal else "fixed")
            args = dict(y=y, f0=f0, **cols(0.3, 1.0))
            if fsal:
                # Per-row tolerances that put each row's ratio at U(0.5, 2), as
                # a controlled solve keeps it: a tiny ratio makes 1/ratio, and
                # so the gradient, ill-conditioned in float32.
                tol = np.full(b, POLY_TOLS[poly])
                ratio = ref.fused_step_poly(*(torch.as_tensor(v).double() if v.dtype != bool
                                              else torch.as_tensor(v) for v in args.values()),
                                            tol, tol, **kw)[1]
                ratio = ratio.numpy()
                aim = rng.uniform(0.5, 2.0, b)
                tol = np.where(ratio > 0, tol * ratio / aim, tol).astype(dtype)
                args.update(atol=tol, rtol=tol.copy())
            else:
                args.update(atol=POLY_TOLS[poly], rtol=POLY_TOLS[poly])
            out.append(dict(op="fused_step_poly", label=f"{method}/{poly}", args=dict(
                **args, **kw), cot=cots(4, ratio=fsal)))
    return out


def _event_cases(seed, b, f, dtype, E):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(dtype)

    out = []
    for i, active in enumerate(("mixed", "all", "none")):
        coeffs, lo, hi, v_lo, v_mid, mask = bisect_inputs(seed + i, b, f, dtype, active)
        out.append(dict(op="masked_bisect_refine", label=f"active={active}", args=dict(
            coeffs=coeffs, lo=lo, hi=hi, v_lo=v_lo, v_mid=v_mid, active=mask),
            cot=(r(b), r(b), r(b), r(b), r(b, f))))
    v_prev, v_new, fired, accept, directions = detect_inputs(seed + 3, b, max(E, 3), dtype)
    out.append(dict(op="fused_event_detect", label=f"E={max(E, 3)}", args=dict(
        v_prev=v_prev, v_new=v_new, fired=fired, accept=accept, directions=directions),
        cot=(r(b, max(E, 3)),)))
    for i, terminal in enumerate(("mixed", "all", "none")):
        x, y_ev, newly, y_new, t0, dt, fired, ev_t, ev_y, flags = commit_inputs(
            seed + 4 + i, b, f, E, dtype, terminal, rows="classes")
        out.append(dict(op="fused_event_commit", label=f"terminal={terminal}", args=dict(
            x=x, y_ev=y_ev, newly=newly, y_new=y_new, t0=t0, dt=dt, fired=fired, ev_t=ev_t,
            ev_y=ev_y, terminal=flags), cot=(r(b, E), r(b, E, f), r(b), r(b, f))))
    return out


def _stiff_cases(seed, b, f, dtype):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(dtype)

    kinds = [k for k, need in (("chord", 1), ("zero_diag", 2), ("ties", 3)) if f >= need]
    out = []
    for kind in kinds:
        # The matrices chip_smoke.py's kernels phase holds the kernel's
        # permutation to LAPACK's on (seed f + len(kind)): a pivot decided
        # by rounding (a near tie) would part the gradients.
        M = chord_matrices(f + len(kind), b, f, dtype, kind)
        out.append(dict(op="batched_lu_factor", label=kind, args=dict(A=M),
                        cot=(r(b, f, f),)))
        for active in ("mixed", "all", "none"):
            M, rhs, k, fk, mask, scale = newton_inputs(f + len(kind), b, f, dtype, kind,
                                                       active)
            lu, perm = (x.numpy() for x in ref.batched_lu_factor(torch.as_tensor(M)))
            label = f"{kind}/active={active}"
            if active == "mixed":
                out.append(dict(op="batched_linsolve", label=kind, args=dict(A=M, rhs=rhs),
                                cot=(r(b, f),)))
            out.append(dict(op="fused_newton_iter", label=label, args=dict(
                lu=lu, perm=perm, k=k, fk=fk, active=mask, scale=scale),
                cot=(r(b, f), r(b))))
            out.append(dict(op="masked_newton_update", label=label, args=dict(
                k=k, delta=rhs, active=mask, scale=scale), cot=(r(b, f), r(b))))
    return out


def _explicit_cases(rng, b, f, n, dtype, seed, tol_kinds, mask_kinds):
    """The explicit ops' cases, drawn from ``cases``' generator ``rng``."""
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


def cases(b, f, n, dtype, seed=0, tol_kinds=TOL_KINDS, mask_kinds=MASK_KINDS, ops=EXPLICIT,
          E=EVENTS_E):
    """Every case of ``ops`` at one (b, f), n eval points and E events,
    numpy ``dtype``."""
    out = []
    if any(op in ops for op in EXPLICIT):
        out += _explicit_cases(np.random.default_rng(seed), b, f, n, dtype, seed, tol_kinds,
                               mask_kinds)
    # The other kinds draw from seeds of their own.
    if any(op in ops for op in FUSED):
        out += _step_cases(np.random.default_rng(seed + 40), b, f, dtype)
    if any(op in ops for op in EVENTS):
        out += _event_cases(seed + 50, b, f, dtype, E)
    if any(op in ops for op in STIFF):
        out += _stiff_cases(seed + 60, b, f, dtype)
    return [c for c in out if c["op"] in ops]


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


def stand_in(name):
    """The CUDA wrapper ``name`` stood in by its plain op under no grad,
    counted in ``cuda_impl.launches`` as the wrapper counts: with it patched
    into ``cuda_impl`` (and the op routed to the card), a Function's forward
    is the plain op's and only its backward is under test.  ``interp_eval``
    and ``fused_event_commit`` write into the buffer they are given, as the
    kernels do; the fused steps fill ``errs=`` (and ``stages=``,
    ``stage_args=``) with the plain error estimate (and stages and their
    arguments)."""
    def launch(*a, **kw):
        with torch.no_grad():
            if name == "interp_eval":
                coeffs, x, mask, out, cursor = a[:5]
                res = out.copy_(plain(name)(coeffs, x, mask, out, cursor))
            elif name == "fused_event_commit":
                res = list(ref.fused_event_commit(*a, **kw))
                res[2] = a[8].copy_(res[2])
                res = tuple(res)
            elif name in ("fused_step", "fused_step_poly"):
                stages, errs = kw.pop("stages", None), kw.pop("errs", None)
                zs = kw.pop("stage_args", None)
                res = getattr(ref, name)(*a, **kw)
                if name == "fused_step":
                    K = a[1]
                else:
                    K = ref.poly_stages(a[0], a[1], a[5], kw["a"], kw["poly"])
                if stages is not None:
                    stages.copy_(K)
                if zs is not None:
                    for i in range(1, K.shape[0]):
                        zs[i - 1] = ref.stage_accum(a[0], a[5], K[:i],
                                                    np.asarray(kw["a"])[i, :i])
                if errs is not None:
                    errs.copy_(ref.fused_update(a[0], K, a[6 if name == "fused_step" else 5],
                                                kw["b_sol"], kw["b_err"])[1])
            else:
                res = getattr(ref, name)(*a, **kw)
        cuda_impl.launches[name] += 1
        return _fresh_outputs(name, res, a)
    return launch


def _fresh_outputs(name, res, inputs):
    """A stand-in's outputs as the kernel's: where the plain op hands an
    input back as an output (the fixed controller's history, a row with no
    terminal event's y_stop), a copy of it -- the kernel writes every output
    into a buffer of its own, but for the buffers it writes in place
    (``interp_eval``'s ``out``, ``fused_event_commit``'s ``ev_y``) and the
    fused steps' c0, which is the input y."""
    if not isinstance(res, tuple):
        return res
    given = [x for x in inputs if isinstance(x, torch.Tensor)]
    out = []
    for i, r in enumerate(res):
        if isinstance(r, tuple):  # the fused steps' coefficients: c0 is y
            r = (r[0], *(_copy_if_given(c, given) for c in r[1:]))
        elif not (name == "fused_event_commit" and i == 2):
            r = _copy_if_given(r, given)
        out.append(r)
    return tuple(out)


def _copy_if_given(r, given):
    return r.clone() if isinstance(r, torch.Tensor) and any(r is g for g in given) else r


def _tensor(x, device, grad):
    if isinstance(x, tuple):
        return tuple(_tensor(c, device, grad) for c in x)
    if not isinstance(x, np.ndarray):
        return x
    t = torch.as_tensor(x, device=device)
    if not t.is_floating_point():
        return t
    return t.requires_grad_(grad)


def _flat(outs):
    """The floating tensors among an op's outputs, nested tuples flattened."""
    if isinstance(outs, torch.Tensor):
        return [outs] if outs.is_floating_point() else []
    if isinstance(outs, (tuple, list)):
        return [t for o in outs for t in _flat(o)]
    return []


def _graph(case, fn, device):
    """``fn`` run on the case's inputs as fresh tensors: ``(args, outputs,
    cotangents, inputs)``, the inputs in ``DIFF`` order (the coefficient
    planes one by one; a tolerance given as a number left out)."""
    op = case["op"]
    args = {k: v if k in CONSTS.get(op, ()) else _tensor(v, device, k in DIFF[op])
            for k, v in case["args"].items()}
    outs = _flat(fn(**args))
    assert len(case["cot"]) == len(outs), f"{op}: {len(outs)} outputs, {len(case['cot'])} cots"
    # A None cotangent leaves its output out, as a loss that does not read it.
    outs = [o for o, c in zip(outs, case["cot"]) if c is not None]
    cots = [torch.as_tensor(c, device=device) for c in case["cot"] if c is not None]
    inputs = [t for k in _diff(case, args)
              for t in (args[k] if isinstance(args[k], tuple) else (args[k],))]
    return args, outs, cots, inputs


def _diff(case, args):
    return [k for k in DIFF[case["op"]] if isinstance(args.get(k), (torch.Tensor, tuple))]


def case_grads(case, fn, device):
    """``torch.autograd.grad`` of ``fn(**case["args"])`` against the case's
    cotangents, for each differentiable input: a dict name -> tensor (a
    tuple for the coefficients), None where the input does not reach the
    outputs."""
    args, outs, cots, inputs = _graph(case, fn, device)
    grads = list(torch.autograd.grad(outs, inputs, cots, allow_unused=True))
    res = {}
    for k in _diff(case, args):
        if isinstance(args[k], tuple):
            res[k] = tuple(grads.pop(0) for _ in args[k])
        else:
            res[k] = grads.pop(0)
    return res


def time_backward(case, device, median_ms):
    """The backward pass alone -- ``torch.autograd.grad`` over a graph built
    once and kept -- of the Function and of the plain op on the case's
    inputs, timed by ``median_ms``: ``{"function": ms, "plain":
    ms}``."""
    res = {}
    for label, fn in (("function", function(case["op"])), ("plain", plain(case["op"]))):
        _, outs, cots, inputs = _graph(case, fn, device)
        res[label] = median_ms(lambda: torch.autograd.grad(outs, inputs, cots, retain_graph=True,
                                                           allow_unused=True))
    return res


def _pairs(name, got, want):
    """(input name, got, want) for each gradient both sides give."""
    for k in want:
        pairs = (zip(got[k], want[k]) if isinstance(want[k], tuple) else ((got[k], want[k]),))
        for g, w in pairs:
            if w is None or g is None:
                assert g is None and w is None, f"{name}: d/d{k} is None on one side only"
                continue
            yield k, g, w


def _worst(got, want):
    fin = torch.isfinite(want)
    return float((got - want)[fin].abs().max()) if bool(fin.any()) else 0.0


def hold(name, got, want, dtype):
    """The rule (see the module docstring), entry by entry.  Returns the
    largest absolute difference over the finite entries; raises
    AssertionError otherwise."""
    tol = tolerance(dtype)
    worst = 0.0
    for k, g, w in _pairs(name, got, want):
        torch.testing.assert_close(g, w, rtol=tol, atol=tol, equal_nan=True,
                                   msg=lambda m, k=k: f"{name}: d/d{k}: {m}")
        worst = max(worst, _worst(g, w))
    return worst


# The batch axis of each gradient: the stacked stages K are (s, b, f).
BATCH_AXIS = {"K": 1}


def _row_max(x, k):
    """The largest entry of each batch row of ``x`` (gradient of input
    ``k``), broadcast back to x's shape; a 0-d gradient is one row."""
    if not x.dim():
        return x
    axis = BATCH_AXIS.get(k, 0)
    rows = x.movedim(axis, 0).reshape(x.shape[axis], -1).amax(dim=1)
    shape = [1] * x.dim()
    shape[axis] = -1
    return rows.reshape(shape).expand_as(x)


def _same_non_finite(name, k, g, w):
    nan, fin = torch.isnan(w), torch.isfinite(w)
    assert torch.equal(torch.isnan(g), nan) and torch.equal(
        g[~fin & ~nan], w[~fin & ~nan]), f"{name}: d/d{k}: the non-finite entries differ"
    return fin


def hold_to_row_max(name, got, want, dtype):
    """The non-finite entries equal, and each finite entry within the
    tolerance times (1 + the largest finite magnitude in its batch row) --
    one instance's entries.  It holds every entry the entry-by-entry rule
    holds, and loosens only an entry far below its row's largest: a
    triangular solve's rounding error scales with its row's largest entry
    (``newton_checks.hold``'s rule, row by row).  Returns the largest
    absolute difference over the finite entries."""
    tol = tolerance(dtype)
    worst = 0.0
    for k, g, w in _pairs(name, got, want):
        fin = _same_non_finite(name, k, g, w)
        bound = tol * (1.0 + _row_max(torch.where(fin, w.abs(), torch.zeros_like(w)), k))
        over = fin & ((g - w).abs() > bound)
        assert not bool(over.any()), (
            f"{name}: d/d{k}: {int(over.sum())} of {w.numel()} entries beyond tol x (1 + "
            f"the row's largest); worst {float(((g - w).abs() / bound)[fin].max())} x the bound")
        if bool(fin.any()):
            worst = max(worst, float(((g - w).abs() / bound)[fin].max()))
    return worst


def hold_to_float64(name, got, want, want64, dtype, check=True):
    """The float32 rule of the fused and Newton backwards on the card,
    against ``want64``, autograd of the same plain op in float64 on the
    same inputs: the non-finite entries of ``got`` and ``want`` equal, and
    in each batch row the largest error of ``got`` against ``want64`` at
    most twice the largest error of ``want`` (autograd of the plain op in
    float32) plus the tolerance times (1 + the row's largest): the
    Function is as accurate as autograd of the plain op, whose error where
    a gradient cancels (an error estimate's dt, a polynomial's stages) is
    far above the tolerance.  Returns the largest ratio of a row's error
    to its bound (``check=False``: without refusing one above 1)."""
    tol = tolerance(dtype)
    worst = 0.0
    for k, g, w in _pairs(name, got, want):
        w64 = want64[k].to(torch.float64)
        fin = _same_non_finite(name, k, g, w) & torch.isfinite(w64)
        g64, wd = g.to(torch.float64), w.to(torch.float64)

        def rows(x):
            return _row_max(torch.where(fin, x, torch.zeros_like(x)), k)
        err, floor = rows((g64 - w64).abs()), rows((wd - w64).abs())
        bound = 2.0 * floor + tol * (1.0 + rows(w64.abs()))
        over = fin & (err > bound)
        assert not (check and bool(over.any())), (
            f"{name}: d/d{k}: a row's error against float64 beyond 2 x the plain op's + tol x "
            f"(1 + the row's largest); worst {float((err / bound)[fin].max())} x the bound")
        if bool(fin.any()):
            worst = max(worst, float((err / bound)[fin].max()))
    return worst


def entry_margin(got, want, dtype):
    """The largest ``|got - want| / (tol (1 + |want|))`` over the finite
    entries: above 1 where the entry-by-entry rule would refuse."""
    tol = tolerance(dtype)
    worst = 0.0
    for _, g, w in _pairs("entry_margin", got, want):
        fin = torch.isfinite(w)
        if bool(fin.any()):
            worst = max(worst, float(((g - w).abs() / (tol * (1.0 + w.abs())))[fin].max()))
    return worst


def as_float64(case):
    """The case with its float32 arrays (inputs and cotangents) cast to
    float64."""
    def cast(x):
        if isinstance(x, tuple):
            return tuple(cast(c) for c in x)
        if isinstance(x, np.ndarray) and x.dtype == np.float32:
            return x.astype(np.float64)
        return x
    return dict(case, args={k: cast(v) for k, v in case["args"].items()},
                cot=tuple(cast(c) for c in case["cot"]))


def hold_on_card(name, case, got, want, dtype, device):
    """The card's rule for the nine backwards of the fused, event and stiff
    paths, ``got`` the Function's gradients and ``want`` those of
    ``card_plain``: the event ops entry by entry (``hold``); the fused
    steps and Newton ops row by row in float64 (``hold_to_row_max``) and
    against the float64 plain op in float32 (``hold_to_float64``).
    Returns ``(rule, largest absolute difference from want, margin)``,
    the margin the largest ratio of a difference to the rule's bound."""
    op = case["op"]
    worst = max((_worst(g, w) for _, g, w in _pairs(name, got, want)), default=0.0)
    if op in EVENTS:
        hold(name, got, want, dtype)
        return "hold", worst, entry_margin(got, want, dtype)
    if dtype == torch.float64:
        return "hold_to_row_max", worst, hold_to_row_max(name, got, want, dtype)
    want64 = case_grads(as_float64(case), card_plain(op), device)
    return "hold_to_float64", worst, hold_to_float64(name, got, want, want64, dtype)


def _kernel_valued(name, fn):
    """``fn``, the plain op ``name``, under autograd with its floating
    outputs replaced by the kernel's values (``plain + (kernel -
    plain).detach()``): autograd of the plain op at the kernel's bits.  On
    the CPU the "kernel" is the plain op itself."""
    def run(*a, **kw):
        out = fn(*a, **kw)
        with torch.no_grad():
            kern = (getattr(cuda_impl, name) if a[0].is_cuda else fn)(*a, **kw)
        if isinstance(out, tuple):
            return tuple(o + (k - o).detach() for o, k in zip(out, kern))
        return out + (kern - out).detach()
    return run


def card_plain(op):
    """The plain op the card holds a Function to: ``plain(op)``, and for the
    fused steps the plain composition with each of its ``stage_accum``,
    ``fused_update`` and ``error_norm`` valued as the kernel
    (``_kernel_valued``), so that its forward has the fused kernel's bits
    while every derivative is autograd's of a plain op.  The plain ops on
    their own round their stages, and so the error estimate, apart from the
    kernel's, and a float32 error ratio moves by far more than the
    backward's own rounding."""
    fn = plain(op)
    if op not in FUSED:
        return fn
    valued = {k: _kernel_valued(k, getattr(ref, k))
              for k in ("stage_accum", "fused_update", "error_norm")}

    def on_card_path(**kw):
        from unittest import mock

        with mock.patch.multiple(ref, **valued):
            return fn(**kw)
    return on_card_path


CARD_VS_CPU = 1e-9  # float64 gradients, card against CPU, relative to the largest


def train_grads(device, driver="scan", mode="joint", rows=None, checkpoint_every=0,
                fused=False, events=False):
    """One forward and backward of ``workloads.full_width_train``'s reduced
    float64 twin on ``device``: ``(loss, grads, counts)``, ``grads`` the
    numpy gradients of y0 and of every weight (``w1, b1, w2, b2``).
    ``driver="scan"``: ``ScanAdjoint`` with dense output (``fused`` and
    ``events`` as the solve takes them), the MSE against the target
    trajectory, ``counts`` the numpy per-row ``n_steps`` (and ``n_events``);
    ``"backsolve"``: ``BacksolveAdjoint(mode=mode)``, the MSE of the final
    state against the target's last point (``counts`` None)."""
    from ..core import BacksolveAdjoint, ScanAdjoint
    from . import workloads

    vf, y0, te, kw, target = workloads.full_width_train(device, reduced=True, events=events)
    if rows is not None:
        y0, target = y0[:rows], target[:rows]
    y0 = torch.as_tensor(y0, device=device).requires_grad_()
    weights = kw["args"]
    tols = dict(rtol=kw["rtol"], atol=kw["atol"])
    if driver == "scan":
        sol = ScanAdjoint(max_steps=workloads.TRAIN["max_steps"],
                          checkpoint_every=checkpoint_every, fused=fused,
                          events=kw.get("events"), **tols).solve(
            vf, y0, te, args=weights, device=device)
        loss, counts = workloads.mse(sol.ys, target), _counts(sol)
    else:
        y1 = BacksolveAdjoint(mode=mode, **tols).solve(
            vf, y0, t_start=float(te[0]), t_end=float(te[-1]), args=weights, device=device)
        loss, counts = workloads.mse(y1, target[:, -1]), None
    grads = torch.autograd.grad(loss, [y0, *weights.values()])
    return float(loss.detach()), [g.detach().cpu().numpy() for g in grads], counts


COUNTS = ("n_steps", "n_events", "n_newton_iters", "n_jac_evals")


def _counts(sol):
    """The per-row counts of a solve that it has (``COUNTS``), as numpy."""
    return {k: sol.stats[k].cpu().numpy() for k in COUNTS if k in sol.stats}


def stiff_grads(device, fused=False, reduced=True, max_steps=None):
    """One forward and backward of ``workloads.allen_cahn_full`` (kvaerno5)
    through ``ScanAdjoint`` on ``device``: the mean square of the final
    state, differentiated in y0 and in lam (a 0-d tensor).  ``fused``: the
    factor-once Newton (``batched_lu_factor`` + ``fused_newton_iter``), else
    ``batched_linsolve`` + ``masked_newton_update``.  ``reduced``: the
    float64 twin of ``workloads.STIFF_REDUCED``, else the full width in
    float32.  Returns ``(loss, grads,
    counts)`` as ``train_grads`` does."""
    from ..core import ScanAdjoint
    from . import workloads

    if reduced:
        red = workloads.STIFF_REDUCED
        np_dtype, b, f = np.float64, red["b"], red["f"]
        max_steps = max_steps or red["max_steps"]
    else:
        np_dtype, b, f = np.float32, workloads.STIFF["b"], workloads.ALLEN_CAHN["f"]
    vf, y0, _, kw = workloads.allen_cahn_full(np_dtype, b=b, f=f)
    tdtype = torch.float64 if np_dtype == np.float64 else torch.float32
    lam = torch.tensor(kw["args"], dtype=tdtype, device=device, requires_grad=True)
    y0 = torch.as_tensor(y0, device=device).requires_grad_()
    sol = ScanAdjoint(kw["method"], rtol=kw["rtol"], atol=kw["atol"], max_steps=max_steps,
                      fused=fused).solve(
        vf, y0, None, t_start=kw["t_start"], t_end=kw["t_end"], args=lam, device=device)
    loss = torch.mean(sol.ys * sol.ys)
    grads = torch.autograd.grad(loss, [y0, lam])
    return float(loss.detach()), [g.detach().cpu().numpy() for g in grads], _counts(sol)


def hold_card_to_cpu(name, card, cpu):
    """A card run of ``train_grads`` or ``stiff_grads`` against the CPU's:
    equal counts and every gradient within ``CARD_VS_CPU`` of the CPU's,
    relative to the CPU gradient's largest entry.  Returns the largest
    relative difference."""
    if cpu[2] is not None:
        for k, want in cpu[2].items():
            assert np.array_equal(card[2][k], want), f"{name}: {k} {card[2][k]} != {want}"
    worst = 0.0
    for g, w in zip(card[1], cpu[1]):
        assert np.isfinite(g).all(), f"{name}: a card gradient is not finite"
        worst = max(worst, float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-300)))
    assert worst <= CARD_VS_CPU, f"{name}: card gradients differ by {worst} relative"
    return worst
