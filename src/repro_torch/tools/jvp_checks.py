"""The cases and the rule of the thirteen solver Functions' ``jvp``
(``kernels/autograd.py``), shared by ``tests/test_torch_jvp.py`` and
``chip_smoke.py``.

The inputs are ``grad_checks.cases(...)``: the ops' boundary cases (widths,
masks, tolerance kinds, windows, event rows, stiff cases), made from a seed.
``tangents(case, seed)`` draws, from the same kind of seed, a tangent for
every differentiable input the case gives as an array (``grad_checks.DIFF``;
each coefficient plane on its own).  ``case_jvp(case, fn, device)`` runs
``torch.func.jvp`` of ``fn`` -- the plain op of ``ref.py`` or the Function
-- on fresh tensors along those tangents and returns the tangents of the
op's floating outputs, in order (nested tuples flattened, as
``grad_checks`` flattens them); ``mode="forward_ad"`` runs it through
``torch.autograd.forward_ad`` dual tensors instead.  ``hold`` is the rule:
the same non-finite entries, every other within ``step_checks.tolerance``
(1e-5 float32, 1e-12 float64) relative and absolute, entry by entry, as
``grad_checks.hold`` holds the backwards; the card holds the fused steps
and the Newton ops row by row (``hold_on_card``), as it holds their
backwards.

``LINEAR`` names the ops whose tangent is a launch of their own kernel (the
op is linear in what carries the tangent), and ``TANGENT_LAUNCHES`` how many
launches the tangent of one call adds when every differentiable input
carries one.  ``solve_tangents(...)`` is one whole forward-mode solve: the
tangent of ``ys`` (and of the event outputs) along a tangent in y0, in the
vector field's parameters and, where asked, in ``t_eval``, with its counts;
the tests hold it to ``jax.jvp`` of the reference and ``chip_smoke.py`` the
card's to the CPU's.  ``jvp_solve(...)`` is a full-width workload's primal
and ``torch.func.jvp`` solve (``workload_jvp``'s inputs and tangents),
timed, with launches and per-row counts, for ``chip_smoke.py`` and
``profile_step.py --jvp``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd import forward_ad as fwad

from ..kernels import ref
from . import grad_checks
from .step_checks import tolerance

OPS = grad_checks.OPS
LINEAR = ("stage_accum", "fused_update", "interp_eval", "masked_newton_update",
          "batched_linsolve")
# The kernel launches one call's jvp adds with every differentiable input
# carrying a tangent: the op's own kernel again (twice where dt's term is a
# second launch, or the derivative polynomial's) -- and fused_newton_iter's
# one launch on every row; none for the others.
TANGENT_LAUNCHES = {"stage_accum": 2, "fused_update": 2, "interp_eval": 2,
                    "masked_newton_update": 1, "batched_linsolve": 1, "fused_newton_iter": 1}


def tangents(case, seed, device=None):
    """A tangent (numpy, the input's dtype) for each differentiable array
    input of the case: a tuple of them for the coefficient planes.  With
    ``device``, tensors drawn there by torch from ``seed`` instead (at full
    width numpy's draws outlast the checks)."""
    if device is None:
        rng = np.random.default_rng(seed)

        def draw(c):
            return rng.standard_normal(c.shape).astype(c.dtype)
    else:
        gen = torch.Generator(device=device).manual_seed(seed)

        def draw(c):
            return torch.randn(c.shape, generator=gen, device=device,
                               dtype=torch.from_numpy(c.reshape(-1)[:0]).dtype)
    out = {}
    for k in grad_checks.DIFF[case["op"]]:
        v = case["args"].get(k)
        if isinstance(v, tuple):
            out[k] = tuple(draw(c) for c in v)
        elif isinstance(v, np.ndarray) and v.dtype.kind == "f":
            out[k] = draw(v)
    return out


def _tensor(x, device):
    if isinstance(x, tuple):
        return tuple(_tensor(c, device) for c in x)
    return torch.tensor(x, device=device) if isinstance(x, np.ndarray) else x


def stiff_main_cases(b, f, dtype, seed=0):
    """One case of each Newton op at (b, f) -- the chord matrices with
    distinct pivots, rows mixed active -- as ``grad_checks.cases`` makes
    them, without the other kinds' (b, f, f) draws: the card's cases at
    allen_cahn_full's width, where its timed rows are."""
    from .newton_checks import newton_inputs

    M, rhs, k, fk, mask, scale = newton_inputs(f + len("chord"), b, f, dtype, "chord", "mixed")
    lu, perm = (x.numpy() for x in ref.batched_lu_factor(torch.as_tensor(M)))
    return [dict(op="batched_lu_factor", label="chord", args=dict(A=M), cot=()),
            dict(op="batched_linsolve", label="chord", args=dict(A=M, rhs=rhs), cot=()),
            dict(op="fused_newton_iter", label="chord/active=mixed", args=dict(
                lu=lu, perm=perm, k=k, fk=fk, active=mask, scale=scale), cot=()),
            dict(op="masked_newton_update", label="chord/active=mixed", args=dict(
                k=k, delta=rhs, active=mask, scale=scale), cot=())]


def jvp_call(case, fn, device, tans=None):
    """``(call, primals, tangents)``: ``fn`` on the case's inputs as fresh
    tensors on ``device``, as a function of its differentiable inputs (the
    coefficient planes one by one) returning its floating outputs, with
    those inputs and their tangents (default ``tangents(case, 0)``)."""
    op = case["op"]
    tans = tangents(case, 0) if tans is None else tans
    consts = grad_checks.CONSTS.get(op, ())
    args = {k: v if k in consts else _tensor(v, device) for k, v in case["args"].items()}
    names = list(tans)
    primals, dirs = [], []
    for k in names:
        vs, ts = args[k], _tensor(tans[k], device)
        primals += list(vs) if isinstance(vs, tuple) else [vs]
        dirs += list(ts) if isinstance(ts, tuple) else [ts]

    def call(*flat):
        it = iter(flat)
        kw = dict(args)
        for k in names:
            kw[k] = (tuple(next(it) for _ in args[k]) if isinstance(args[k], tuple)
                     else next(it))
        return tuple(grad_checks._flat(fn(**kw)))

    return call, tuple(primals), tuple(dirs)


def case_jvp(case, fn, device, tans=None, mode="func"):
    """The tangents of ``fn(**case["args"])``'s floating outputs along
    ``tans`` (default ``tangents(case, 0)``), by ``torch.func.jvp``
    (``mode="func"``) or ``torch.autograd.forward_ad`` (``"forward_ad"``).
    Returns ``(outputs, tangents)``, two lists of tensors."""
    call, primals, dirs = jvp_call(case, fn, device, tans)
    if mode == "func":
        outs, touts = torch.func.jvp(call, primals, dirs)
        return list(outs), list(touts)
    with fwad.dual_level():
        pairs = [fwad.unpack_dual(o) for o in call(*(fwad.make_dual(p, t)
                                                        for p, t in zip(primals, dirs)))]
        return ([p.primal.clone() for p in pairs],
                [torch.zeros_like(p.primal) if p.tangent is None else p.tangent.clone()
                 for p in pairs])


def _kernel_valued(name, fn):
    """``fn``, the plain op ``name``, on forward-mode dual tensors with its
    floating outputs' values replaced by the kernel's on the primals
    (``grad_checks._kernel_valued``'s counterpart for tangents): the plain
    op's tangent formula, evaluated downstream at the kernel's bits.  On the
    CPU the "kernel" is the plain op itself."""
    from ..kernels import cuda_impl

    def run(*a, **kw):
        out = fn(*a, **kw)
        prim = [fwad.unpack_dual(x).primal if isinstance(x, torch.Tensor) else x for x in a]
        with torch.no_grad():
            kern = (getattr(cuda_impl, name) if prim[0].is_cuda else fn)(*prim, **kw)

        def swap(o, k):
            t = fwad.unpack_dual(o).tangent
            return k if t is None else fwad.make_dual(k, t)
        if isinstance(out, tuple):
            return tuple(swap(o, k) for o, k in zip(out, kern))
        return swap(out, kern)
    return run


def card_plain_jvp(case, device, tans=None):
    """The tangents the card holds a fused step's jvp to: the plain
    composition (``grad_checks.plain``) under ``forward_ad``, each of its
    ``stage_accum``, ``fused_update`` and ``error_norm`` valued as the
    kernel, so that its forward has the fused kernel's bits (the fused
    kernels equal the unfused card path bitwise) while every tangent is the
    plain op's formula -- as ``grad_checks.card_plain`` for the backwards.
    Returns ``(outputs, tangents)``."""
    from unittest import mock

    from ..kernels import ref

    valued = {k: _kernel_valued(k, getattr(ref, k))
              for k in ("stage_accum", "fused_update", "error_norm")}
    with mock.patch.multiple(ref, **valued):
        return case_jvp(case, grad_checks.plain(case["op"]), device, tans, mode="forward_ad")


def hold(name, got, want, dtype, rule="entries"):
    """``got`` (the Function's output tangents) against ``want`` (the plain
    op's): the same non-finite entries, and each finite one within the
    tolerance relative and absolute (``rule="rows"``: times 1 + the largest
    finite magnitude of its batch row, ``grad_checks.hold_to_row_max``).
    Returns the largest absolute difference over the finite entries."""
    assert len(got) == len(want), f"{name}: {len(got)} tangents, want {len(want)}"
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.to(w.device)
        if rule == "rows":
            grad_checks.hold_to_row_max(f"{name}[out {i}]", {"out": g}, {"out": w}, dtype)
        else:
            tol = tolerance(dtype)
            torch.testing.assert_close(g, w, rtol=tol, atol=tol, equal_nan=True,
                                       msg=lambda m, i=i: f"{name}: output {i}: {m}")
        fin = torch.isfinite(w)
        if bool(fin.any()):
            worst = max(worst, float((g - w)[fin].abs().max()))
    return worst


def hold_on_card(name, case, got, want, dtype, device, tans):
    """The card's rule, as ``grad_checks.hold_on_card`` has it for the
    backwards: the event ops and the explicit ops entry by entry; the fused
    steps and the Newton ops (the kernel's ratios and factors carry its own
    rounding into every entry of a row) row by row in float64
    (``grad_checks.hold_to_row_max``) and in float32 against the plain op's
    jvp in float64 on the same inputs (``grad_checks.hold_to_float64``),
    which reads no kernel.  For the fused steps ``want``, the float32 floor,
    is ``card_plain_jvp``'s: the plain tangent formula at the kernel's
    forward bits.  Returns ``(rule, largest absolute difference, margin)``."""
    op = case["op"]
    worst = max((float((g.to(w.device) - w)[torch.isfinite(w)].abs().max())
                 for g, w in zip(got, want) if bool(torch.isfinite(w).any())), default=0.0)
    if op not in grad_checks.FUSED + grad_checks.STIFF:
        hold(name, got, want, dtype)
        return "entries", worst, None
    keyed = [{f"out{i}": t for i, t in enumerate(ts)} for ts in (got, want)]
    if dtype == torch.float64:
        return "rows", worst, grad_checks.hold_to_row_max(name, *keyed, dtype)
    def as64(c):
        return c.double() if isinstance(c, torch.Tensor) else c.astype(np.float64)

    tans64 = {k: tuple(map(as64, v)) if isinstance(v, tuple) else as64(v)
              for k, v in tans.items()}
    _, want64 = case_jvp(grad_checks.as_float64(case), grad_checks.plain(op), device, tans64)
    return "float64", worst, grad_checks.hold_to_float64(
        name, *keyed, {f"out{i}": t for i, t in enumerate(want64)}, dtype)


# ------------------------------------------------------------ whole solves


def solve_tangents(device, path, dtype=torch.float64, mode="func", wrt=("y0", "args"),
                   seed=0, **sizes):
    """One forward-mode solve of ``path`` (a key of ``PATHS``) on
    ``device``: ``(sol, tangents, counts)``, the tangents those of ``ys``
    (and ``event_t``, ``event_y`` for the event paths) as numpy along
    tangents drawn from ``seed`` in the inputs ``wrt`` names (``"y0"``,
    ``"args"``, ``"t_eval"``).  ``mode``: ``"func"`` (``torch.func.jvp``),
    ``"forward_ad"``, or ``"primal"`` (the same solve without tangents:
    tangents None)."""
    from ..core import solve_ivp, solve_ivp_scan

    make = PATHS[path]
    vf, y0, te, args, kw, scan = make(dtype, **sizes)
    rng = np.random.default_rng(seed)
    prim = {"y0": y0, "args": args, "t_eval": te}
    tan = {k: rng.standard_normal(np.shape(prim[k])) for k in wrt if prim[k] is not None}
    if "t_eval" in tan:
        tan["t_eval"] = tan["t_eval"] * 1e-2
    names = list(tan)
    solve = solve_ivp_scan if scan else solve_ivp

    def run(*xs):
        given = dict(prim)
        given.update(zip(names, xs))
        sol = solve(vf, given["y0"], given["t_eval"], args=given["args"], device=device, **kw)
        outs = [sol.ys] + ([sol.event_t, sol.event_y] if sol.event_t is not None else [])
        run.sol = sol
        return tuple(outs)

    def tens(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    primals = tuple(tens(prim[k]) for k in names)
    dirs = tuple(tens(tan[k]) for k in names)
    if mode == "func":
        outs, touts = torch.func.jvp(run, primals, dirs)
    elif mode == "primal":
        outs = run(*primals)
        touts = (None,) * len(outs)
    else:
        with fwad.dual_level():
            outs = run(*(fwad.make_dual(p, t) for p, t in zip(primals, dirs)))
            touts = tuple(fwad.unpack_dual(o).tangent for o in outs)
            outs = tuple(fwad.unpack_dual(o).primal for o in outs)
    sol = run.sol
    counts = grad_checks._counts(sol)
    return ([o.detach().cpu().numpy() for o in outs],
            [None if t is None else t.detach().cpu().numpy() for t in touts], counts)


def workload_jvp(vf, y0, te, kw, device, rows=None, dtype=None):
    """A workload's ``solve_ivp`` (``tools/workloads.py``: ``(vf, y0, te,
    kw)``) set up for a jvp on ``device``, rows ``:rows`` of y0 in
    ``dtype``: ``(solve, primals, tangents)``, ``solve(y0, args)`` the
    ``Solution``, the tangents in y0 and in every parameter (a dict of
    weights at 1e-2 of a normal draw, or a scalar), drawn from seed 11."""
    from ..core import solve_ivp

    tdev = torch.device(device)
    y = torch.as_tensor(y0 if rows is None else y0[:rows], device=tdev)
    y = y.to(dtype or y.dtype)
    args = kw["args"]
    args = ({k: a.detach().to(device=tdev, dtype=y.dtype) for k, a in args.items()}
            if isinstance(args, dict) else torch.tensor(args, device=tdev, dtype=y.dtype))
    kw = {k: v for k, v in kw.items() if k != "args"}
    rng = np.random.default_rng(11)
    tan_y = torch.as_tensor(rng.standard_normal(tuple(y0.shape))[:y.shape[0]], device=tdev,
                            dtype=y.dtype)
    tan_a = (torch.as_tensor(rng.standard_normal(()), device=tdev, dtype=y.dtype)
             if not isinstance(args, dict) else
             {k: 1e-2 * torch.as_tensor(rng.standard_normal(tuple(a.shape)), device=tdev,
                                        dtype=a.dtype) for k, a in args.items()})

    def solve(yy, aa):
        return solve_ivp(vf, yy, te, args=aa, device=tdev, **kw)

    return solve, (y, args), (tan_y, tan_a)


def jvp_solve(vf, y0, te, kw, device, rows=None, dtype=None, reset_launches=None):
    """A primal solve and a ``torch.func.jvp`` solve of ``workload_jvp``'s
    problem: ``(summary, tangent, counts)``, the summary with the step
    count, ms and ms a step of both, and -- with ``reset_launches`` -- the
    launches of both and the tangent's (the jvp's less the primal's);
    ``counts`` the jvp solve's per-row counts (``grad_checks.COUNTS``).
    Raises where the jvp solve took other steps than the primal or its
    tangent is not finite."""
    import time

    from ..kernels import ops

    solve, (y, args), dirs = workload_jvp(vf, y0, te, kw, device, rows, dtype)
    cuda = torch.device(device).type == "cuda"

    def clock():
        if cuda:
            torch.cuda.synchronize()
        return time.perf_counter()

    def run(yy, aa):
        run.sol = solve(yy, aa)
        return run.sol.ys

    def counted():
        return {k: v for k, v in ops.launches.items() if v}

    with torch.no_grad():
        if reset_launches:
            reset_launches()
        t0 = clock()
        ys = run(y, args)
        t1 = clock()
    primal = counted()
    steps = int(run.sol.stats["n_steps"].max())
    if reset_launches:
        reset_launches()
    t2 = clock()
    ys_j, tan = torch.func.jvp(run, (y, args), dirs)
    t3 = clock()
    launches = counted()
    if int(run.sol.stats["n_steps"].max()) != steps:
        raise RuntimeError("jvp: the jvp solve took other steps than the primal solve")
    if not bool(torch.isfinite(tan).all()):
        raise RuntimeError("jvp: the tangent is not finite")
    out = dict(steps=steps, primal_bitwise=bool(torch.equal(ys_j, ys)),
               primal_ms=(t1 - t0) * 1e3, jvp_ms=(t3 - t2) * 1e3,
               primal_ms_a_step=(t1 - t0) * 1e3 / steps, jvp_ms_a_step=(t3 - t2) * 1e3 / steps)
    if reset_launches:
        out.update(primal_launches=primal, jvp_launches=launches,
                   tangent_launches={k: launches.get(k, 0) - primal.get(k, 0) for k in primal})
    return out, tan, grad_checks._counts(run.sol)


def _decay(dtype, b=3, f=2):
    """``f = -a y + 0.1 sin(t) y^2`` per feature, ``a`` the parameters."""
    rng = np.random.default_rng(1)

    def vf(t, y, a):
        return -a * y + 0.1 * torch.sin(t)[:, None] * y * y

    y0 = rng.uniform(0.5, 1.5, (b, f))
    a = rng.uniform(0.5, 2.0, f)
    return vf, y0, np.linspace(0.0, 2.0, 5), a


def _explicit(method, fused=False):
    def make(dtype, b=3, f=2):
        vf, y0, te, a = _decay(dtype, b, f)
        return vf, y0, te, a, dict(method=method, rtol=1e-8, atol=1e-8, fused=fused), False
    return make


def _events(terminal):
    # The solver's default tolerances: an event time's tangent carries the
    # step size's, which the error estimate's cancellation makes sensitive
    # to rounding by ~1/rtol (tests/test_torch_jvp_paths.py, EVENT_KW).
    def make(dtype, b=3, f=2):
        from ..core import Event

        vf, y0, te, a = _decay(dtype, b, f)
        ev = Event(lambda t, y, args: y[0] - 0.7, terminal=terminal, direction=-1.0)
        return vf, y0, te, a, dict(rtol=1e-3, atol=1e-6, events=ev), False
    return make


def _poly(dtype, b=3, f=2):
    """The logistic as a ``polynomial_term``, fused: one ``fused_step_poly``
    launch a step; no parameters (its coefficients are static)."""
    from ..core import polynomial_term

    _, y0, te, _ = _decay(dtype, b, f)
    return (polynomial_term(0.0, 1.0, -1.0), y0, te, None,
            dict(rtol=1e-8, atol=1e-8, fused=True), False)


def _stiff(fused):
    def make(dtype, b=3, f=4):
        rng = np.random.default_rng(2)

        def vf(t, y, lam):  # a stiff linear chain with a cubic term
            lead = -lam * y + 0.5 * torch.roll(y, 1, dims=1)
            return lead - y * y * y

        y0 = rng.uniform(0.2, 1.0, (b, f))
        return vf, y0, np.linspace(0.0, 0.1, 3), np.asarray(50.0), dict(
            method="kvaerno5", rtol=1e-6, atol=1e-8, fused=fused), False
    return make


def _scan(every):
    def make(dtype, b=3, f=2):
        vf, y0, te, a = _decay(dtype, b, f)
        return vf, y0, te, a, dict(rtol=1e-8, atol=1e-8, max_steps=40,
                                   checkpoint_every=every), True
    return make


PATHS = {
    "dopri5": _explicit("dopri5"), "dopri5_fused": _explicit("dopri5", True),
    "tsit5": _explicit("tsit5"), "tsit5_fused": _explicit("tsit5", True),
    "events_terminal": _events(True), "events_marker": _events(False),
    "kvaerno5": _stiff(False), "kvaerno5_factor_once": _stiff(True),
    "scan": _scan(0), "scan_checkpointed": _scan(16), "poly_fused": _poly,
}

CARD_VS_CPU = 1e-9  # float64 tangents, card against CPU, relative to the largest


def hold_card_to_cpu(name, card, cpu):
    """A card run of ``solve_tangents`` against the CPU's: equal counts,
    equal NaN entries, every other within ``CARD_VS_CPU`` of the CPU
    tangent's largest entry.  Returns the largest relative difference."""
    for k, want in cpu[2].items():
        assert np.array_equal(card[2][k], want), f"{name}: {k} {card[2][k]} != {want}"
    worst = 0.0
    for g, w in zip(card[1], cpu[1]):
        assert np.array_equal(np.isnan(g), np.isnan(w)), f"{name}: NaN entries differ"
        fin = np.isfinite(w)
        if fin.any():
            rel = float(np.abs(g[fin] - w[fin]).max() / max(np.abs(w[fin]).max(), 1e-300))
            worst = max(worst, rel)
    assert worst <= CARD_VS_CPU, f"{name}: card tangents differ by {worst} relative"
    return worst
