"""Forward mode through the thirteen solver kernels' autograd Functions
(``repro_torch.kernels.autograd``), on the CPU.

Every kernel is stood in by its plain op under no grad (the ``card``
fixture, ``grad_checks.stand_in``), so a Function's forward is the plain
op's and what is tested is its ``jvp``; ``chip_smoke.py``'s phase ``jvp``
holds the real kernels.

- Each Function's ``jvp`` against ``torch.func.jvp`` of the plain op in
  ``kernels/ref.py`` on ``grad_checks``' cases (``jvp_checks.tangents`` for
  every differentiable input), both dtypes, widths 1, 2, 3, 5, 33, under
  ``torch.func.jvp`` and ``torch.autograd.forward_ad``: the same non-finite
  entries, every other within 1e-12 (float64) / 1e-5 (float32) relative.
  The ops linear in what carries the tangent launch their kernel again
  (``jvp_checks.TANGENT_LAUNCHES``, counted), and no jvp calls an op of
  ``ref.py``.
- Whole forward-mode solves through the Functions against the plain CPU
  solve: tangents within 1e-12 of their largest entry, equal counts, and
  every tangent launch counted (``TANGENT_LAUNCHES`` times the primal
  launches).
- ``ops`` sends a dual or ``torch.func``-wrapped tensor to the Function and
  a plain one where it goes today; a raw ``cuda_impl`` wrapper refuses a
  tangent; the in-place ops write a copy when a tangent rides on them.
- The two primal-neutral repairs: ``stepper._tableau_arrays``' dtype table
  and ``ref.batched_lu_factor``'s permutation, bitwise as before.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.autograd import forward_ad as fwad  # noqa: E402

from repro_torch.core import stepper, tableau  # noqa: E402
from repro_torch.kernels import autograd as AG  # noqa: E402
from repro_torch.kernels import cuda_impl, ops, ref  # noqa: E402
from repro_torch.tools import grad_checks, jvp_checks  # noqa: E402

WIDTHS = (1, 2, 3, 5, 33)
MODES = ("func", "forward_ad")


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


# ------------------------------------------------------------- the jvps


@pytest.mark.parametrize("op", grad_checks.OPS)
@pytest.mark.parametrize("f", WIDTHS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_jvp_matches_plain(card, dtype, f, op):
    tdtype = torch.float32 if dtype == np.float32 else torch.float64
    checked = 0
    for case in grad_checks.cases(13, f, 9, dtype, seed=f, ops=(op,)):
        _, want = jvp_checks.case_jvp(case, grad_checks.plain(op), "cpu")
        for mode in MODES:
            _, got = jvp_checks.case_jvp(case, grad_checks.function(op), "cpu", mode=mode)
            jvp_checks.hold(f"{op}[{case['label']}] {mode}", got, want, tdtype)
            checked += 1
    # One launch for the forward, and the tangent's own launches.
    assert checked and card[op] == checked * (1 + jvp_checks.TANGENT_LAUNCHES.get(op, 0))


def test_tangent_launches_name_the_linear_ops():
    """The ops linear in what carries the tangent relaunch their kernel;
    fused_newton_iter relaunches for its substitution; the others none."""
    assert set(jvp_checks.LINEAR) < set(jvp_checks.TANGENT_LAUNCHES)
    assert set(jvp_checks.TANGENT_LAUNCHES) - set(jvp_checks.LINEAR) == {"fused_newton_iter"}
    assert set(jvp_checks.TANGENT_LAUNCHES) <= set(grad_checks.OPS)


def test_jvp_only_where_a_tangent_arrives(card):
    """A tangent in dt alone: stage_accum's dt term alone (one launch); in
    K alone: the K term alone; no tangent on the op: no jvp at all."""
    case = grad_checks.cases(4, 3, 9, np.float64, ops=("stage_accum",))[1]
    full = jvp_checks.tangents(case, 0)
    for keep, launches in ((("dt",), 2), (("K",), 2), (("y",), 1)):
        card["stage_accum"] = 0
        tans = {k: full[k] for k in keep}
        _, want = jvp_checks.case_jvp(case, grad_checks.plain("stage_accum"), "cpu", tans=tans)
        _, got = jvp_checks.case_jvp(case, AG.stage_accum, "cpu", tans=tans)
        jvp_checks.hold("stage_accum", got, want, torch.float64)
        assert card["stage_accum"] == launches, (keep, card["stage_accum"])


RAISING = (*grad_checks.OPS, "interp_eval_window", "pid_update", "hermite_coeffs", "poly_eval",
           "poly_stages", "rms_norm", "broadcast_tolerances", "_lu_solve_perm", "_masked_commit")


@pytest.mark.parametrize("op", grad_checks.OPS)
def test_jvp_calls_no_plain_op(card, op, monkeypatch):
    """Every op of ``ref.py`` raises unless a stand-in kernel runs it: the
    forward and the jvp's own launches are kernels, the rest plain torch."""
    case = grad_checks.cases(5, 3, 9, np.float64, ops=(op,))[0]
    _, want = jvp_checks.case_jvp(case, grad_checks.plain(op), "cpu")
    inside = []
    originals = {name: getattr(ref, name) for name in RAISING}

    def guard(name):
        def run(*a, **k):
            if not inside:
                raise AssertionError(f"a jvp called ref.{name}")
            return originals[name](*a, **k)
        return run

    def kernel(name, launch):
        def run(*a, **k):
            inside.append(name)
            try:
                return launch(*a, **k)
            finally:
                inside.pop()
        return run

    for name in RAISING:
        monkeypatch.setattr(ref, name, guard(name))
    for name in grad_checks.OPS:
        monkeypatch.setattr(cuda_impl, name, kernel(name, getattr(cuda_impl, name)))
    for mode in MODES:
        _, got = jvp_checks.case_jvp(case, grad_checks.function(op), "cpu", mode=mode)
        jvp_checks.hold(op, got, want, torch.float64)


# --------------------------------------------------------- whole solves

SOLVES = ("dopri5", "dopri5_fused", "tsit5", "events_marker", "events_terminal", "kvaerno5",
          "kvaerno5_factor_once", "scan_checkpointed")


@pytest.mark.parametrize("path", SOLVES)
def test_solves_through_functions_match_plain(card, path):
    """Tangents of ys (and the event outputs) through the Functions equal
    the plain solve's within 1e-12 of their largest entry, with equal
    counts; each op launched (1 + its tangent launches) times a primal
    solve's launches (a checkpointed block's recompute is the backward's:
    forward mode runs each block once)."""
    sizes = dict(b=2, f=3) if path.startswith("kvaerno5") else {}
    got = jvp_checks.solve_tangents("cpu", path, mode="func", **sizes)
    counts = dict(card)
    card.update(dict.fromkeys(card, 0))
    with torch.no_grad():
        jvp_checks.solve_tangents("cpu", path, mode="primal", **sizes)
    primal = dict(card)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "_on_cuda", lambda name, t: False)
        want = jvp_checks.solve_tangents("cpu", path, mode="func", **sizes)
    for k in want[2]:
        np.testing.assert_array_equal(got[2][k], want[2][k], err_msg=k)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        fin = np.isfinite(w)
        assert np.abs(g[fin] - w[fin]).max() <= 1e-12 * max(np.abs(w[fin]).max(), 1e-300)
    assert any(primal.values())
    for op, n in primal.items():
        assert counts[op] == n * (1 + jvp_checks.TANGENT_LAUNCHES.get(op, 0)), (op, counts, primal)


def test_forward_ad_solve_matches_func(card):
    """The same tangents through forward_ad dual tensors."""
    got = jvp_checks.solve_tangents("cpu", "events_marker", mode="forward_ad")
    want = jvp_checks.solve_tangents("cpu", "events_marker", mode="func")
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------ the routes


def _stage_inputs():
    case = grad_checks.cases(4, 3, 9, np.float64, ops=("stage_accum",))[1]
    y, dt, K = (torch.as_tensor(case["args"][k]) for k in ("y", "dt", "K"))
    return y, dt, K, case["args"]["coeffs"]


def test_ops_send_tangents_to_the_functions(card, monkeypatch):
    """A dual tensor or a torch.func wrapper takes the Function (its jvp
    runs); a plain tensor, with or without a dual level open, the kernel
    alone, as before."""
    y, dt, K, c = _stage_inputs()
    calls = []
    rule = AG.StageAccum.jvp

    def counted(ctx, *t):
        calls.append(1)
        return rule(ctx, *t)

    monkeypatch.setattr(AG.StageAccum, "jvp", staticmethod(counted))
    ops.stage_accum(y, dt, K, c)
    assert card["stage_accum"] == 1 and not calls
    with fwad.dual_level():
        ops.stage_accum(y, dt, K, c)  # no tangent: the kernel alone
        assert card["stage_accum"] == 2 and not calls
        out = ops.stage_accum(fwad.make_dual(y, torch.ones_like(y)), dt, K, c)
        assert fwad.unpack_dual(out).tangent is not None and calls == [1]
    torch.func.jvp(lambda yy: ops.stage_accum(yy, dt, K, c), (y,), (torch.ones_like(y),))
    assert calls == [1, 1]
    assert not cuda_impl.forward_mode() and not ops.carries_tangent((y, dt, K))


def test_in_place_ops_write_a_copy_under_a_tangent(card):
    """interp_eval and fused_event_commit update their buffer in place on
    the card; with a tangent the Function writes into a copy."""
    case = grad_checks.cases(4, 3, 9, np.float64, ops=("interp_eval",))[0]
    a = {k: (tuple(torch.as_tensor(c) for c in v) if isinstance(v, tuple)
             else torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
         for k, v in case["args"].items()}
    before = a["out"].clone()
    with fwad.dual_level():
        x = fwad.make_dual(a["x"], torch.ones_like(a["x"]))
        res = ops.interp_eval(a["coeffs"], x, a["mask"], a["out"])
        assert res is not a["out"] and torch.equal(a["out"], before)
    assert ops.interp_eval(a["coeffs"], a["x"], a["mask"], a["out"]) is a["out"]
    case = grad_checks.cases(4, 3, 9, np.float64, ops=("fused_event_commit",))[0]
    a = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
         for k, v in case["args"].items()}
    ev_y = a["ev_y"].clone()
    args = [a[k] for k in ("x", "y_ev", "newly", "y_new", "t0", "dt", "fired", "ev_t")]
    _, tout = torch.func.jvp(
        lambda yn: ops.fused_event_commit(*args[:3], yn, *args[4:], a["ev_y"],
                                          terminal=a["terminal"])[5],
        (a["y_new"],), (torch.ones_like(a["y_new"]),))
    assert torch.equal(a["ev_y"], ev_y) and tout.shape == a["y_new"].shape


def test_raw_wrappers_refuse_a_tangent():
    """A raw kernel wrapper refuses a dual tensor and a torch.func wrapper
    (rather than drop the tangent), before it reads a byte."""
    y, dt, K, c = _stage_inputs()
    with fwad.dual_level():
        with pytest.raises(RuntimeError, match="forward-mode tangent"):
            cuda_impl.stage_accum(fwad.make_dual(y, torch.ones_like(y)), dt, K, c)
    with pytest.raises(RuntimeError, match="forward-mode tangent"):
        torch.func.jvp(lambda yy: cuda_impl.stage_accum(yy, dt, K, c), (y,),
                       (torch.ones_like(y),))
    with pytest.raises(RuntimeError, match="forward-mode tangent"):
        torch.func.jvp(lambda A: cuda_impl.batched_lu_factor(A), (K[:, :3, :3],),
                       (torch.ones(K.shape[0], 3, 3, dtype=K.dtype),))
    # A plain CPU tensor still meets the device check, as before.
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_impl.stage_accum(y, dt, K, c)


def test_nested_transforms_are_refused(card):
    """The Functions carry one level of forward mode: a jvp of a jvp
    through one raises rather than drop the outer tangent."""
    y, dt, K, c = _stage_inputs()
    one = torch.ones_like(y)

    def inner(yy):
        return torch.func.jvp(lambda z: ops.stage_accum(z, dt, K * yy.sum(), c), (yy,),
                              (one,))[1]

    with pytest.raises(NotImplementedError, match="one torch.func transform"):
        torch.func.jvp(inner, (y,), (one,))


# ------------------------------------------------------- primal-neutral


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tableau_arrays_unchanged(dtype):
    """The dtype table gives each tableau's arrays bitwise as reading the
    numpy dtype off a tensor did, and works under torch.func.jvp."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    for name in tableau.TABLEAUS:
        tab = tableau.get_tableau(name)
        got = stepper._tableau_arrays(tab, dtype)
        want = (np.asarray(tab.a, dtype=np_dtype), np.asarray(tab.c, dtype=np_dtype),
                np.asarray(tab.b_sol, dtype=np_dtype),
                np.asarray(tab.b_err, dtype=np_dtype) if tab.b_err is not None
                else np.zeros((tab.stages,), dtype=np_dtype))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w), name
    x = torch.ones(2, dtype=dtype)
    out, _ = torch.func.jvp(lambda v: v * float(stepper._tableau_arrays(
        tableau.get_tableau("dopri5"), v.dtype)[2][0]), (x,), (x,))
    assert out.dtype == dtype


@pytest.mark.parametrize("f", [1, 2, 3, 5, 33, 160])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lu_permutation_unchanged(f, dtype):
    """``ref.batched_lu_factor`` reads its permutation off the pivots as
    before (``lu_unpack`` of the factors), bitwise, and under
    ``torch.func.jvp``; f = 160 takes the matrix-at-a-time branch."""
    g = torch.Generator().manual_seed(f)
    A = torch.randn(3, f, f, generator=g, dtype=dtype)
    lu, perm = ref.batched_lu_factor(A)
    if f > ref.LU_BATCHED_MAX_F:
        parts = [torch.linalg.lu_factor_ex(A[i:i + 1]) for i in range(3)]
        lu0, piv = torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
    else:
        lu0, piv, _ = torch.linalg.lu_factor_ex(A)
    P, _, _ = torch.lu_unpack(lu0, piv, unpack_data=False)
    assert torch.equal(perm, P.argmax(dim=-2).to(torch.int32))
    assert torch.equal(lu, lu0.contiguous())
    (lu_j, perm_j), _ = torch.func.jvp(ref.batched_lu_factor, (A,), (torch.ones_like(A),))
    assert torch.equal(perm_j, perm) and torch.equal(lu_j, lu)


# ------------------------------------------------------- the card's rules


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_card_rule_by_op(dtype):
    """``jvp_checks.hold_on_card`` holds the explicit and event ops entry by
    entry, the fused steps and Newton ops row by row in float64 and against
    the float64 plain op in float32; the plain op's own tangents pass each."""
    tdtype = torch.float32 if dtype == np.float32 else torch.float64
    seen = set()
    for case in grad_checks.cases(5, 2, 9, dtype, seed=2, ops=grad_checks.OPS):
        tans = jvp_checks.tangents(case, 0)
        _, want = jvp_checks.case_jvp(case, grad_checks.plain(case["op"]), "cpu", tans)
        rule, err, margin = jvp_checks.hold_on_card(case["op"], case, want, want, tdtype, "cpu",
                                                    tans)
        assert err == 0.0 and (margin is None or margin <= 1)
        seen.add((case["op"], rule))
    rows = "rows" if dtype == np.float64 else "float64"
    for op in grad_checks.OPS:
        assert {r for o, r in seen if o == op} == (
            {rows} if op in grad_checks.FUSED + grad_checks.STIFF else {"entries"}), op


def test_card_to_cpu_rule_refuses():
    """``hold_card_to_cpu``: equal counts and tangents within 1e-9 of their
    largest entry; a tangent 1e-8 off or a count off is refused."""
    want = jvp_checks.solve_tangents("cpu", "dopri5")
    assert jvp_checks.hold_card_to_cpu("same", want, want) == 0.0
    off = (want[0], [t * (1 + 1e-8) for t in want[1]], want[2])
    with pytest.raises(AssertionError, match="differ by"):
        jvp_checks.hold_card_to_cpu("off", off, want)
    steps = dict(want[2], n_steps=want[2]["n_steps"] + 1)
    with pytest.raises(AssertionError, match="n_steps"):
        jvp_checks.hold_card_to_cpu("steps", (want[0], want[1], steps), want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_card_plain_jvp_is_the_plain_op_on_the_cpu(dtype):
    """``card_plain_jvp`` values the fused steps' inner ops as the kernels
    (the plain ops themselves on the CPU) under forward_ad: on the CPU its
    tangents are the plain op's under ``torch.func.jvp``, bitwise."""
    for case in grad_checks.cases(7, 3, 9, dtype, ops=grad_checks.FUSED):
        tans = jvp_checks.tangents(case, 0)
        _, got = jvp_checks.card_plain_jvp(case, "cpu", tans)
        _, want = jvp_checks.case_jvp(case, grad_checks.plain(case["op"]), "cpu", tans)
        for g, w in zip(got, want):
            assert torch.equal(g.nan_to_num(7.0), w.nan_to_num(7.0)), case["label"]


@pytest.mark.parametrize("op", grad_checks.FUSED + ("fused_newton_iter",))
def test_card_float32_rule_refuses_a_wrong_tangent(card, op):
    """The card's float32 rule (``hold_on_card``: each row against the plain
    op's jvp in float64, which reads no kernel) takes the Function's
    tangents and refuses them with one entry of one output moved by 1 % of
    its row's largest magnitude."""
    for case in grad_checks.cases(13, 5, 9, np.float32, seed=5, ops=(op,)):
        tans = jvp_checks.tangents(case, 0)
        _, want = (jvp_checks.card_plain_jvp(case, "cpu", tans) if op in grad_checks.FUSED
                   else jvp_checks.case_jvp(case, grad_checks.plain(op), "cpu", tans))
        _, got = jvp_checks.case_jvp(case, grad_checks.function(op), "cpu", tans)
        name = f"{op}[{case['label']}]"
        rule, _, margin = jvp_checks.hold_on_card(name, case, got, want, torch.float32,
                                                  "cpu", tans)
        assert rule == "float64" and margin <= 1.0
        for i, t in enumerate(got):
            fin = torch.isfinite(t)
            if t.ndim == 0 or not bool(fin.any()):
                continue
            mag = torch.where(fin, t.abs(), torch.zeros_like(t))
            j = int(mag.argmax())
            wrong = [g.clone() for g in got]
            wrong[i].view(-1)[j] += 1e-2 * (1.0 + float(mag.view(-1)[j]))
            with pytest.raises(AssertionError, match="beyond 2 x the plain op's"):
                jvp_checks.hold_on_card(name, case, wrong, want, torch.float32, "cpu", tans)
