"""Reverse-mode gradients through ``fused=True``, ``events=`` and the stiff
path: the nine backwards of ``repro_torch.kernels.autograd`` that these
paths add (``fused_step``, ``fused_step_poly``, ``masked_bisect_refine``,
``fused_event_detect``, ``fused_event_commit``, ``batched_lu_factor``,
``batched_linsolve``, ``fused_newton_iter``, ``masked_newton_update``), on
the CPU.

Every kernel is stood in by its plain op under no grad (the ``card``
fixture, ``grad_checks.stand_in``): a Function's forward is then the plain
op's, so what is tested is its backward; the card tests and
``chip_smoke.py`` hold the real kernels.

- (a) Each backward against ``torch.autograd.grad`` of the plain op in
  ``kernels/ref.py`` on ``grad_checks``' cases (failed rows, rows not
  running or rejected or clamped, a zero step whose ratio is 0, inactive
  rows, terminal and tied crossings, NaN condition values, shuffled, zero
  and tied pivots), at ``step_checks.tolerance`` (1e-5 float32, 1e-12
  float64) with the same non-finite entries; ``torch.autograd.gradcheck``
  of each in float64; and no backward calls an op of ``ref.py``.
- (b) Whole solves through the Functions against the plain CPU solve within
  1e-12 in float64, with exact kernel launch counts, checkpoint recompute
  included: ``ScanAdjoint`` with ``fused=True`` (a general term and a
  polynomial one), ``events=``, kvaerno5 unfused (``batched_linsolve`` +
  ``masked_newton_update``) and kvaerno5 fused (``factor_once``:
  ``batched_lu_factor`` + ``fused_newton_iter``), and ``AutoDiffAdjoint``
  with ``fused=True``.
- (c) Against the JAX package in float64: ``fused=True`` gradients against
  ``jax.grad`` of its ``solve_ivp_scan(..., fused=True)`` with equal step
  counts at ``GRAD_RTOL`` (1e-9); events against ``jax.grad`` of its event
  solve; kvaerno5 (JAX cannot reverse-differentiate its Newton
  ``while_loop``) against its forward step counts and its dopri5 gradient
  at a tight tolerance.

Marked ``reverse_diff``, as their JAX counterparts are.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import autograd as AG  # noqa: E402
from repro_torch.kernels import cuda_impl, ops, ref  # noqa: E402
from repro_torch.tools import grad_checks  # noqa: E402

pytestmark = pytest.mark.reverse_diff

NINE = grad_checks.FUSED + grad_checks.EVENTS + grad_checks.STIFF
GRAD_RTOL = 1e-9
A0 = np.array([[-0.5, 0.3], [-0.2, -0.8]])
Y0 = np.array([[1.0, 0.5], [0.3, -1.2], [2.0, 0.1]])
TE = np.linspace(0.0, 1.5, 6)
WEIGHTS = np.arange(1.0, 7.0)[None, :, None]
WIDTHS = (1, 2, 3, 5, 33)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def card(monkeypatch):
    """The thirteen solver ops take their CUDA route on CPU tensors, each
    kernel stood in by its plain op under no grad and counted in
    ``launches`` as the wrappers count (``grad_checks.stand_in``)."""
    for name in grad_checks.OPS:
        monkeypatch.setattr(cuda_impl, name, grad_checks.stand_in(name))
    monkeypatch.setattr(ops, "_on_cuda", lambda name, t: name in grad_checks.OPS)
    saved = dict(cuda_impl.launches)
    cuda_impl.launches.update(dict.fromkeys(cuda_impl.launches, 0))
    yield cuda_impl.launches
    cuda_impl.launches.update(saved)


# ------------------------------------------------------------ (a) backwards


@pytest.mark.parametrize("op", NINE)
@pytest.mark.parametrize("f", WIDTHS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_backward_matches_plain(card, dtype, f, op):
    tdtype = torch.float32 if dtype == np.float32 else torch.float64
    checked = 0
    for case in grad_checks.cases(13, f, 9, dtype, seed=f, ops=(op,)):
        want = grad_checks.case_grads(case, grad_checks.plain(op), "cpu")
        got = grad_checks.case_grads(case, grad_checks.function(op), "cpu")
        grad_checks.hold(f"{op}[{case['label']}]", got, want, tdtype)
        checked += 1
    assert checked and card[op] == checked


def test_cases_cover_the_boundaries():
    """The cases hold what the module docstring of ``grad_checks`` names:
    failed, idle and zero-step rows; NaN condition values; every terminal
    kind; tied and zero pivots; inactive Newton rows."""
    cases = grad_checks.cases(13, 5, 9, np.float64, ops=NINE)
    labels = {(c["op"], c["label"]) for c in cases}
    assert ("fused_step", "kvaerno5/failed/full_tol") in labels
    assert ("fused_step", "rk4/fixed") in labels
    assert {("fused_step_poly", f"{m}/logistic") for m in ("dopri5", "rk4")} <= labels
    assert {("fused_event_commit", f"terminal={k}") for k in ("mixed", "all", "none")} <= labels
    assert {("batched_lu_factor", k) for k in ("chord", "zero_diag", "ties")} <= labels
    assert ("fused_newton_iter", "ties/active=none") in labels
    step = next(c for c in cases if c["label"] == "dopri5/pid")["args"]
    assert step["safe_dt"][0] == 0 and not step["running"].all()
    values = np.concatenate([c["args"][k] for c in cases if c["op"] == "masked_bisect_refine"
                             for k in ("v_lo", "v_mid")])
    assert np.isnan(values).any() and (values == 0).any()
    failed = next(c for c in cases if c["label"] == "kvaerno5/failed/row_tol")["args"]
    assert failed["failed"].any() and failed["f0"] is not None


def test_failed_and_zero_ratio_rows_are_nan_as_plain(card):
    """A row whose ratio is 0 gets NaN gradients (0 * inf), and a failed row
    whose norm before the failure was 0 does too: the Function recomputes
    that norm, as autograd's sqrt divides by it."""
    case = next(c for c in grad_checks.cases(13, 5, 9, np.float64, ops=("fused_step",))
                if c["label"] == "kvaerno5/failed/full_tol")
    case["args"]["safe_dt"][1] = 0.0  # err = 0 ...
    case["args"]["failed"][1] = True  # ... in a failed row
    want = grad_checks.case_grads(case, grad_checks.plain("fused_step"), "cpu")
    got = grad_checks.case_grads(case, grad_checks.function("fused_step"), "cpu")
    assert bool(want["y"][1].isnan().all()) and bool(want["y"][0].isnan().all())
    grad_checks.hold("fused_step[failed zero row]", got, want, torch.float64)


def _gradcheck_inputs(op, seed=0):
    g = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    b, f = 3, 4

    def r(*s, scale=1.0):
        return (scale * torch.randn(*s, generator=g, dtype=torch.float64)).requires_grad_()

    def u(lo, hi, *s):
        return (lo + (hi - lo) * torch.rand(*s, generator=g, dtype=torch.float64)
                ).requires_grad_()

    if op in ("fused_step", "fused_step_poly"):
        tab = "dopri5"
        a, c, bs, be = grad_checks._tableau(tab)
        running = torch.tensor([True, True, False])
        cols = (u(0.0, 1.0, b), u(1.0, 2.0, b), u(0.3, 0.6, b), u(0.3, 0.6, b))
        hist = (u(0.5, 2.0, b), u(0.5, 2.0, b))
        atol, rtol = u(1e-4, 2e-4, b), 1e-4
        kw = dict(b_sol=bs, b_err=be, ctrl=grad_checks.PID, want_coeffs=True)
        if op == "fused_step":
            # No failed row here: its ratio is inf, and finite differences of
            # inf are NaN (the failed rows are held to autograd in (a)).
            def fn(y, K, f1, t, t_new, dt_cur, safe_dt, pi1, pi2, atol, f0):
                return AG.fused_step(y, K, f1, t, t_new, dt_cur, safe_dt, running, pi1, pi2,
                                     atol, rtol, f0=f0, **kw)
            return fn, (r(b, f), r(7, b, f, scale=0.01), r(b, f), *cols, *hist, atol, r(b, f))

        def fn(y, f0, t, t_new, dt_cur, safe_dt, pi1, pi2, atol):
            return AG.fused_step_poly(y, f0, t, t_new, dt_cur, safe_dt, running, pi1, pi2,
                                      atol, rtol, a=a, c=c, poly=grad_checks.POLYS["logistic"],
                                      **kw)
        y = u(0.5, 1.5, b, f)
        return fn, (y, ref.poly_eval(y.detach(), grad_checks.POLYS["logistic"])
                    .requires_grad_(), *cols, *hist, atol)
    if op == "masked_bisect_refine":
        active = torch.tensor([True, False, True])
        v_lo = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64, requires_grad=True)
        v_mid = torch.tensor([-1.0, 3.0, 0.7], dtype=torch.float64, requires_grad=True)
        return (lambda lo, hi, vl, vm, *cs: AG.masked_bisect_refine(cs, lo, hi, vl, vm, active),
                (u(0.0, 0.4, b), u(0.6, 1.0, b), v_lo, v_mid, *(r(b, f) for _ in range(4))))
    if op == "fused_event_detect":
        fired = torch.tensor([[False, True], [False, False], [True, False]])
        accept = torch.tensor([True, False, True])
        return (lambda vp, vn: AG.fused_event_detect(vp, vn, fired, accept,
                                                     directions=(0.0, 1.0))[1],
                (r(b, 2), r(b, 2)))
    if op == "fused_event_commit":
        newly = torch.tensor([[True, True], [False, True], [True, False]])
        fired = torch.tensor([[False, False], [True, False], [False, True]])
        x = torch.tensor([[0.3, 0.6], [0.5, 0.2], [0.8, 0.1]], dtype=torch.float64,
                         requires_grad=True)

        def fn(x, y_ev, y_new, t0, dt, ev_t, ev_y):
            out = AG.fused_event_commit(x, y_ev, newly, y_new, t0, dt, fired, ev_t, ev_y,
                                        terminal=(True, False))
            return out[1], out[2], out[4], out[5]
        return fn, (x, r(b, 2, f), r(b, f), r(b), u(0.1, 0.5, b), r(b, 2), r(b, 2, f))
    M, rhs, k, fk, mask, scale = (torch.as_tensor(v) for v in grad_checks.newton_inputs(
        seed, b, f, np.float64, "chord", "mixed"))
    M.requires_grad_()
    if op == "batched_lu_factor":
        return (lambda A: AG.batched_lu_factor(A)[0]), (M,)
    if op == "batched_linsolve":
        return AG.batched_linsolve, (M, rhs.requires_grad_())
    scale = (scale * 1e3).requires_grad_()
    if op == "masked_newton_update":
        return (lambda k, d, s: AG.masked_newton_update(k, d, mask, s),
                (k.requires_grad_(), rhs.requires_grad_(), scale))
    lu, perm = ref.batched_lu_factor(M.detach())
    return (lambda lu, k, fk, s: AG.fused_newton_iter(lu, perm, k, fk, mask, s),
            (lu.requires_grad_(), k.requires_grad_(), fk.requires_grad_(), scale))


@pytest.mark.parametrize("op", NINE)
def test_gradcheck(card, op):
    fn, inputs = _gradcheck_inputs(op)
    assert torch.autograd.gradcheck(lambda *a: tuple(grad_checks._flat(fn(*a))), inputs)


@pytest.mark.parametrize("op", NINE)
def test_backward_calls_no_plain_op(card, op):
    """Each backward runs with every plain op of ``ref.py`` made to raise:
    the forward (the stand-in) is done, and the backward needs none."""
    case = grad_checks.cases(5, 3, 9, np.float64, ops=(op,))[0]
    _, outs, cots, inputs = grad_checks._graph(case, grad_checks.function(op), "cpu")
    with pytest.MonkeyPatch.context() as mp:
        for name in (*grad_checks.OPS, "interp_eval_window", "pid_update", "hermite_coeffs",
                     "poly_eval", "poly_stages", "rms_norm", "broadcast_tolerances",
                     "_lu_solve_perm", "_masked_commit"):
            mp.setattr(ref, name, _raise)
        grads = torch.autograd.grad(outs, inputs, cots, allow_unused=True)
    assert any(g is not None for g in grads)


def _raise(*a, **k):
    raise AssertionError("a backward called an op of ref.py")


def test_ops_take_the_functions_only_under_autograd(card):
    """On the card route, grad on and an input that requires grad: the
    Function (``fused_event_commit`` writes a copy of ``ev_y``); otherwise
    the kernel itself, in place."""
    case = grad_checks.cases(4, 3, 9, np.float64, ops=("fused_event_commit",))[0]
    x, y_ev, newly, y_new, t0, dt, fired, ev_t, ev_y = (
        torch.as_tensor(case["args"][k]) for k in
        ("x", "y_ev", "newly", "y_new", "t0", "dt", "fired", "ev_t", "ev_y"))
    term = case["args"]["terminal"]
    before = ev_y.clone()
    y_req = y_new.clone().requires_grad_()
    out = ops.fused_event_commit(x, y_ev, newly, y_req, t0, dt, fired, ev_t, ev_y,
                                 terminal=term)
    assert type(out[5].grad_fn).__name__ == "FusedEventCommitBackward"
    assert torch.equal(ev_y, before) and out[2] is not ev_y
    with torch.no_grad():
        out = ops.fused_event_commit(x, y_ev, newly, y_req, t0, dt, fired, ev_t, ev_y,
                                     terminal=term)
    assert out[2] is ev_y
    M = torch.as_tensor(grad_checks.newton_inputs(0, 2, 3, np.float64)[0])
    assert ops.batched_lu_factor(M)[0].grad_fn is None
    lu, perm = ops.batched_lu_factor(M.requires_grad_())
    assert type(lu.grad_fn).__name__ == "BatchedLUFactorBackward" and perm.grad_fn is None
    assert card["fused_event_commit"] == 2 and card["batched_lu_factor"] == 2


def test_raw_wrappers_still_refuse_grad():
    """A raw wrapper called with grad still refuses (the card test runs the
    call), naming the route through ``ops`` for every kernel: the solver's
    and the attention's (``autograd.FlashAttention``)."""
    assert set(cuda_impl._NO_BACKWARD) == set(cuda_impl.launches)
    for name in (*grad_checks.OPS, "flash_attention_fwd", "flash_attention_bwd"):
        assert "autograd Function" in cuda_impl._NO_BACKWARD[name]


# The card's rules.  Two rows 1e6 apart: a wrong entry in the small row is
# within the large row's scale but beyond its own.
def _rows(dtype, wrong=0.0, axis=0):
    want = torch.ones(2, 3, dtype=dtype)
    want[0] *= 1e6
    got = want.clone()
    got[1, 2] += wrong
    if axis:  # (s, b, f): the rows along axis 1
        want, got = want.expand(2, 2, 3).clone(), got.expand(2, 2, 3).clone()
    return got, want


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,axis", [("y", 0), ("K", 1)])
def test_row_rule_refuses_a_wrong_small_row(dtype, name, axis):
    """``hold_to_row_max`` scales each entry by its own batch row (axis 1
    of the stacked stages K): an error of 1e-3 in a row of ones is refused
    although the tensor's largest entry is 1e6; the entry-by-entry margin
    reads it."""
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    got, want = _rows(dtype, 1e-3, axis)
    with pytest.raises(AssertionError, match="beyond tol"):
        grad_checks.hold_to_row_max("rows", {name: got}, {name: want}, dtype)
    assert grad_checks.entry_margin({name: got}, {name: want}, dtype) > 1
    # Within the small row's own scale, it holds.
    got, want = _rows(dtype, 0.5 * tol, axis)
    assert grad_checks.hold_to_row_max("rows", {name: got}, {name: want}, dtype) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_row_rule_is_no_tighter_than_entries_and_keeps_non_finite(dtype):
    """What ``hold`` holds, ``hold_to_row_max`` holds (a 0-d gradient is one
    row); the non-finite entries must be equal."""
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    got, want = _rows(dtype, 0.5 * tol)
    grads = {"y": (got, want), "t": (torch.tensor(3.0, dtype=dtype),) * 2}
    got_d, want_d = ({k: v[i] for k, v in grads.items()} for i in (0, 1))
    grad_checks.hold("e", got_d, want_d, dtype)
    assert 0 < grad_checks.hold_to_row_max("r", got_d, want_d, dtype) <= 1
    nan, inf = want.clone(), want.clone()
    nan[1, 0], inf[1, 1] = float("nan"), float("inf")
    grad_checks.hold_to_row_max("nan", {"y": nan.clone()}, {"y": nan}, dtype)
    for bad in (nan, inf):
        with pytest.raises(AssertionError, match="non-finite"):
            grad_checks.hold_to_row_max("bad", {"y": want}, {"y": bad}, dtype)


def test_float64_rule_refuses_a_less_accurate_row():
    """``hold_to_float64``: a row whose error against the float64 gradient
    is within twice the plain op's (plus the tolerance) holds; the same
    error in a row where the plain op is exact is refused."""
    w64 = torch.tensor([[1e3, 2.0, 3.0], [1.0, 2.0, 3.0]], dtype=torch.float64)
    want = w64.float()
    want[0] += 0.5  # the plain op's float32 error in row 0
    got = want.clone()
    got[0, 1] -= 1.0  # |got - w64| = 0.5 there: within 2 x 0.5
    assert grad_checks.hold_to_float64("ok", {"y": got}, {"y": want}, {"y": w64},
                                       torch.float32) > 0
    got[1, 1] += 1e-3  # row 1: the plain op exact, the Function 1e-3 off
    with pytest.raises(AssertionError, match="beyond 2 x"):
        grad_checks.hold_to_float64("bad", {"y": got}, {"y": want}, {"y": w64}, torch.float32)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_card_rule_by_op(dtype):
    """``hold_on_card`` holds the event ops entry by entry, the fused steps
    and Newton ops row by row in float64 and against the float64 plain op
    in float32; a Function equal to the plain op passes each."""
    tdtype = torch.float32 if dtype == np.float32 else torch.float64
    seen = set()
    for case in grad_checks.cases(5, 2, 9, dtype, seed=2, ops=NINE):
        want = grad_checks.case_grads(case, grad_checks.plain(case["op"]), "cpu")
        rule, err, margin = grad_checks.hold_on_card(case["op"], case, want, want, tdtype,
                                                     "cpu")
        assert err == 0.0 and margin <= 1
        seen.add((case["op"], rule))
    expect = {"hold_to_row_max" if dtype == np.float64 else "hold_to_float64"}
    for op in NINE:
        assert {r for o, r in seen if o == op} == (
            {"hold"} if op in grad_checks.EVENTS else expect), op


@pytest.mark.parametrize("op", grad_checks.FUSED)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_card_plain_is_the_plain_op_on_the_cpu(dtype, op):
    """``card_plain`` values the fused steps' inner ops as the kernels (the
    plain ops themselves on the CPU) and differentiates the plain ops: on
    the CPU its gradients are the plain op's, bitwise, and it calls no
    Function."""
    def boom(*a, **k):
        raise AssertionError("card_plain ran a Function")

    for case in grad_checks.cases(13, 2, 9, dtype, seed=2, ops=(op,)):
        want = grad_checks.case_grads(case, grad_checks.plain(op), "cpu")
        with pytest.MonkeyPatch.context() as m:
            for name in ("stage_accum", "fused_update", "error_norm"):
                m.setattr(AG, name, boom)
            got = grad_checks.case_grads(case, grad_checks.card_plain(op), "cpu")
        for k in want:
            for g, w in zip(*((v if isinstance(v, tuple) else (v,)) for v in (got[k], want[k]))):
                assert (g is None and w is None) or torch.equal(g.nan_to_num(7.0),
                                                                w.nan_to_num(7.0)), k


# ------------------------------------------- (b) whole solves, Functions


def _linear(t, y, A):
    return y @ A.T


def _run(make, te=TE, vf=_linear, y0=Y0, args=A0):
    """``make().solve`` of the linear system with y0 and A requiring grad:
    (solution, gradients of the weighted loss of ys in y0 and A)."""
    y = torch.tensor(y0, requires_grad=True)
    A = torch.tensor(args, requires_grad=True)
    sol = make().solve(vf, y, te, args=A, device="cpu")
    loss = torch.sum(torch.sin(sol.ys) * torch.as_tensor(WEIGHTS))
    if sol.event_t is not None:
        loss = loss + torch.nansum(sol.event_t)
    return sol, torch.autograd.grad(loss, (y, A))


def _plain(make, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "_on_cuda", lambda name, t: False)
        return _run(make, **kw)


# Rows 0 and 2 cross the marker (at y[0] = 0.75 and 1.3); row 2 stops at
# y[1] = -0.17 after that, and row 1 records nothing.
MARK = T.Event(lambda t, y, args: (y[0] - 0.75) * (y[0] - 1.3), terminal=False)
STOP = T.Event(lambda t, y, args: y[1] + 0.17, terminal=True, direction=-1.0)

PATHS = {
    "fused": (lambda every: T.ScanAdjoint(rtol=1e-8, atol=1e-8, max_steps=50, fused=True,
                                          checkpoint_every=every),
              ("fused_step", "interp_eval", "stage_accum")),
    "events": (lambda every: T.ScanAdjoint(rtol=1e-8, atol=1e-8, max_steps=40,
                                           events=(MARK, STOP), checkpoint_every=every),
               ("masked_bisect_refine", "fused_event_detect", "fused_event_commit")),
    "kvaerno5": (lambda every: T.ScanAdjoint("kvaerno5", rtol=1e-7, atol=1e-9, max_steps=40,
                                             checkpoint_every=every),
                 ("batched_linsolve", "masked_newton_update")),
    "kvaerno5_factor_once": (lambda every: T.ScanAdjoint("kvaerno5", rtol=1e-7, atol=1e-9,
                                                         max_steps=40, fused=True,
                                                         checkpoint_every=every),
                             ("batched_lu_factor", "fused_newton_iter", "fused_step")),
}


@pytest.mark.parametrize("every", [0, 16])
@pytest.mark.parametrize("path", list(PATHS))
def test_scan_paths_through_functions_match_plain(card, path, every):
    make, used = PATHS[path]
    sol, grads = _run(lambda: make(every))
    counts = dict(card)
    plain_sol, plain = _plain(lambda: make(every))
    np.testing.assert_array_equal(sol.stats["n_steps"].numpy(),
                                  plain_sol.stats["n_steps"].numpy())
    for g, p in zip(grads, plain):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, p, rtol=1e-12, atol=1e-12)
    assert all(counts[k] > 0 for k in used), counts
    max_steps = make(every).max_steps
    for k in ("fused_step", "fused_event_detect", "fused_event_commit", "batched_lu_factor"):
        if k in used:  # once a loop iteration, twice with checkpointing
            assert counts[k] == max_steps * (2 if every else 1), (k, counts[k])
    if path == "events":  # 31 launches per event bisected: the priming one and 30 halvings
        assert counts["masked_bisect_refine"] % 31 == 0
    if path == "kvaerno5":
        assert counts["batched_linsolve"] == counts["masked_newton_update"]
        assert counts["batched_lu_factor"] == counts["fused_newton_iter"] == 0
    if every:  # each checkpointed block runs once more in the backward
        _run(lambda: make(0))
        once = {k: card[k] - counts[k] for k in counts}
        assert counts == {k: 2 * v for k, v in once.items()}, (counts, once)


def test_events_fire_and_stop_in_the_solve(card):
    """The events solve above records marker crossings in every row and
    stops some rows at the terminal one, so the commit's gradient paths all
    carry weight."""
    sol, _ = _run(lambda: PATHS["events"][0](0))
    assert sol.event_mask.numpy().tolist() == [[True, False], [False, False], [True, True]]
    assert (sol.status.numpy() == T.Status.EVENT.value).tolist() == [False, False, True]


def test_polynomial_fused_through_functions_matches_plain(card):
    """``fused_step_poly``: the whole step in one launch, the stages written
    out for the backward; gradients in y0 against the plain solve."""
    term = T.polynomial_term(0.0, 1.0, -1.0)

    def grads(route):
        y = torch.tensor(np.linspace(0.2, 0.9, 6).reshape(3, 2), requires_grad=True)
        with pytest.MonkeyPatch.context() as mp:
            if route == "plain":
                mp.setattr(ops, "_on_cuda", lambda name, t: False)
            sol = T.ScanAdjoint(rtol=1e-8, atol=1e-8, max_steps=40, fused=True).solve(
                term, y, TE, device="cpu")
            return sol, torch.autograd.grad(torch.sum(torch.sin(sol.ys) * torch.as_tensor(
                WEIGHTS)), y)[0]

    sol, g = grads("card")
    assert card["fused_step_poly"] == 40 and card["fused_step"] == 0
    plain_sol, p = grads("plain")
    np.testing.assert_array_equal(sol.stats["n_steps"].numpy(),
                                  plain_sol.stats["n_steps"].numpy())
    torch.testing.assert_close(g, p, rtol=1e-12, atol=1e-12)


def test_autodiff_fused_through_functions_matches_plain(card):
    make = lambda: T.AutoDiffAdjoint(rtol=1e-8, atol=1e-8, max_steps=64, fused=True)
    sol, grads = _run(make)
    assert card["fused_step"] == int(sol.stats["n_steps"].max())
    _, plain = _plain(make)
    for g, p in zip(grads, plain):
        torch.testing.assert_close(g, p, rtol=1e-12, atol=1e-12)


TWINS = {
    "fused": lambda device: grad_checks.train_grads(device, fused=True, checkpoint_every=16),
    "events": lambda device: grad_checks.train_grads(device, events=True),
    "kvaerno5": lambda device: grad_checks.stiff_grads(device),
    "kvaerno5_factor_once": lambda device: grad_checks.stiff_grads(device, fused=True),
}


@pytest.mark.parametrize("path", list(TWINS))
def test_reduced_twins_through_functions_match_plain(card, path):
    """The reduced float64 twins the card tests and ``chip_smoke.py`` hold
    card to CPU, held here through the Functions to the plain solve by the
    same rule (``hold_card_to_cpu``: equal counts, gradients within 1e-9 of
    their size; ``batched_linsolve``'s backward solves with A^T where
    autograd of the plain op walks back its LU, which at Allen-Cahn's
    conditioning rounds apart by ~1e-12)."""
    got = TWINS[path]("cpu")
    used = {"fused": "fused_step", "events": "fused_event_commit",
            "kvaerno5": "batched_linsolve", "kvaerno5_factor_once": "fused_newton_iter"}[path]
    assert card[used] > 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "_on_cuda", lambda name, t: False)
        want = TWINS[path]("cpu")
    grad_checks.hold_card_to_cpu(path, got, want)
    if path == "events":
        assert want[2]["n_events"].min() >= 1
    assert all(np.isfinite(g).all() and np.abs(g).max() > 0 for g in want[1])


# ------------------------------------------------------- (c) against JAX


def _jax_linear(t, y, A):
    return y @ A.T


def _jax_grads(loss, **kw):
    with jax.enable_x64(True):
        def f(y0, A):
            return loss(J.solve_ivp_scan(_jax_linear, y0, jnp.asarray(TE), args=A, **kw))

        y0, A = jnp.asarray(Y0), jnp.asarray(A0)
        gy, gA = jax.grad(f, argnums=(0, 1))(y0, A)
        steps = J.solve_ivp_scan(_jax_linear, y0, jnp.asarray(TE), args=A, **kw).stats[
            "n_steps"]
        return np.asarray(gy), np.asarray(gA), np.asarray(steps)


def _torch_grads(loss, **kw):
    y0, A = convert.from_numpy(Y0, "cpu").requires_grad_(), torch.tensor(A0, requires_grad=True)
    sol = T.solve_ivp_scan(_linear, y0, TE, args=A, device="cpu", **kw)
    gy, gA = torch.autograd.grad(loss(sol), (y0, A))
    return gy.numpy(), gA.numpy(), sol.stats["n_steps"].numpy()


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("every", [0, 16])
def test_fused_gradients_match_jax_fused(card, every):
    kw = dict(rtol=1e-8, atol=1e-8, max_steps=50, fused=True, checkpoint_every=every)
    tg = _torch_grads(lambda sol: torch.sum(torch.sin(sol.ys) * torch.as_tensor(WEIGHTS)), **kw)
    assert card["fused_step"] == 50 * (2 if every else 1)
    jg = _jax_grads(lambda sol: jnp.sum(jnp.sin(sol.ys) * WEIGHTS), **kw)
    np.testing.assert_array_equal(tg[2], jg[2])
    _close(tg[0], jg[0])
    _close(tg[1], jg[1])


def test_event_gradients_match_jax(card):
    kw = dict(rtol=1e-8, atol=1e-8, max_steps=64)
    mark = lambda t, y, args: (y[0] - 0.75) * (y[0] - 1.3)
    tg = _torch_grads(lambda sol: torch.sum(torch.sin(sol.ys) * torch.as_tensor(WEIGHTS)),
                      events=T.Event(mark, terminal=False), **kw)
    assert card["fused_event_commit"] == 64 and card["masked_bisect_refine"] > 0
    jg = _jax_grads(lambda sol: jnp.sum(jnp.sin(sol.ys) * WEIGHTS),
                    events=J.Event(mark, terminal=False), **kw)
    np.testing.assert_array_equal(tg[2], jg[2])
    _close(tg[0], jg[0])
    _close(tg[1], jg[1])


@pytest.mark.parametrize("fused", [False, True])
def test_kvaerno5_gradients_match_jax_rules(card, fused):
    """JAX cannot reverse-differentiate its Newton loop (a while_loop): the
    step counts equal its forward solve's, and the gradient is within the
    kvaerno5 solve's own error of JAX's dopri5 gradient at 1e-11."""
    kw = dict(method="kvaerno5", rtol=1e-7, atol=1e-9, max_steps=64, fused=fused)
    tg = _torch_grads(lambda sol: torch.sum(torch.sin(sol.ys) * torch.as_tensor(WEIGHTS)), **kw)
    used = ("batched_lu_factor", "fused_newton_iter") if fused else ("batched_linsolve",
                                                                      "masked_newton_update")
    assert all(card[k] > 0 for k in used)
    with jax.enable_x64(True):
        js = J.solve_ivp_scan(_jax_linear, jnp.asarray(Y0), jnp.asarray(TE),
                              args=jnp.asarray(A0), **kw)
        np.testing.assert_array_equal(tg[2], np.asarray(js.stats["n_steps"]))
    jg = _jax_grads(lambda sol: jnp.sum(jnp.sin(sol.ys) * WEIGHTS), rtol=1e-11, atol=1e-11,
                    max_steps=512)
    for got, want in zip(tg[:2], jg[:2]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
