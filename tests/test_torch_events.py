"""The port's event subsystem (``repro_torch.core.events``) against the JAX
package's, on the same numpy inputs.

- (a) ``ref.masked_bisect_refine``, ``ref.fused_event_detect`` and
  ``ref.fused_event_commit`` against ``repro.kernels.ref`` of the same name,
  at f in {1, 37, 200} and E in {1, 3}, over every direction, terminal mix,
  tie and NaN case (``repro_torch.tools.event_checks``): float32 at rtol =
  atol = 1e-6, float64 at 1e-12, masks exactly.
- (b) one small case of each against the Pallas kernel in interpret mode, at
  f = 37 and f = 200.
- (c) whole solves against JAX ``solve_ivp(events=...)`` in float64, every
  semantic case of ``tests/test_events.py`` (its scan-driver case is in
  ``tests/test_torch_grad.py``): equal ``status``, ``n_steps``, ``n_events`` and
  ``event_mask``; ``event_t``, ``event_y``, ``ts`` and ``ys`` within 1e-9.
  Each case runs unfused and fused.
- (d) fused solves with events bitwise equal to unfused ones on the CPU, for
  every explicit tableau x {general vf, ``polynomial_term``} x dense on/off.
- (e) the analytic and golden checks of ``examples/bouncing_ball.py`` and
  ``tests/test_events_golden.py``.

The CUDA kernels themselves are held to these plain versions on the card in
``test_torch_kernels_card.py``.
"""

import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.kernels import pallas_impl  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import cuda_impl, ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.tools import event_checks as EC  # noqa: E402

G = 9.81
TOL = {np.float32: 1e-6, np.float64: 1e-12}
DTYPES = [np.float32, np.float64]
EXPLICIT = sorted(n for n, tab in T.TABLEAUS.items() if not tab.implicit)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _jax(fn, dtype):
    """Run ``fn`` with JAX in the dtype's precision; numpy results out."""
    with jax.enable_x64(dtype == np.float64):
        return jax.tree_util.tree_map(np.asarray, fn())


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jnp(arrays):
    return tuple(jnp.asarray(a) if isinstance(a, np.ndarray)
                 else tuple(jnp.asarray(c) for c in a) if isinstance(a, tuple)
                 and a and isinstance(a[0], np.ndarray) else a for a in arrays)


def _assert_outputs(got, want, dtype, rtol=None):
    """Floating outputs within the dtype's tolerance (NaN where NaN), masks
    and counts exactly."""
    rtol = TOL[dtype] if rtol is None else rtol
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape, k
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol, err_msg=f"output {k}")
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=f"output {k}")


# --------------------------------------------------------------------- (a)

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("active", ["mixed", "all", "none"])
@pytest.mark.parametrize("f", [1, 37, 200])
def test_masked_bisect_refine_matches_jax_ref(f, active, dtype):
    args = EC.bisect_inputs(f, 11, f, dtype, active)
    want = _jax(lambda: jref.masked_bisect_refine(*_jnp(args)), dtype)
    for fn in (tref.masked_bisect_refine, ops.masked_bisect_refine):
        _assert_outputs(fn(*EC.to_torch(args, "cpu")), want, dtype)


def test_bisect_nan_condition_picks_the_left_half():
    """torch.sign(NaN) is 0 and jnp.sign(NaN) is NaN: the plain op must still
    pick the left half for a NaN value at either end, as the JAX op does."""
    coeffs = tuple(torch.zeros(4, 2, dtype=torch.float64) for _ in range(4))
    lo, hi = torch.zeros(4, dtype=torch.float64), torch.ones(4, dtype=torch.float64)
    nan = float("nan")
    v_lo = torch.tensor([nan, 1.0, 0.0, 1.0], dtype=torch.float64)
    v_mid = torch.tensor([0.0, nan, nan, 2.0], dtype=torch.float64)
    active = torch.ones(4, dtype=torch.bool)
    got = tref.masked_bisect_refine(coeffs, lo, hi, v_lo, v_mid, active)
    want = _jax(lambda: jref.masked_bisect_refine(
        tuple(jnp.asarray(c.numpy()) for c in coeffs), *(jnp.asarray(x.numpy()) for x in (
            lo, hi, v_lo, v_mid, active))), np.float64)
    np.testing.assert_array_equal(got[1].numpy(), [0.5, 0.5, 0.5, 1.0])
    _assert_outputs(got, want, np.float64)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("E, directions", [(1, (0.0,)), (1, (1.0,)), (1, (-1.0,)),
                                           (3, (0.0, 1.0, -1.0))],
                         ids=["E1-any", "E1-rising", "E1-falling", "E3-all"])
def test_fused_event_detect_matches_jax_ref(E, directions, dtype):
    v_prev, v_new, fired, accept, _ = EC.detect_inputs(E, 64, E, dtype)
    args = (v_prev, v_new, fired, accept)
    want = _jax(lambda: jref.fused_event_detect(*_jnp(args), directions=directions), dtype)
    for fn in (tref.fused_event_detect, ops.fused_event_detect):
        got = fn(*EC.to_torch(args, "cpu"), directions=directions)
        assert got[0].dtype == torch.bool
        _assert_outputs(got, want, dtype)
    assert want[0].any() and not want[0][np.isnan(v_prev) | np.isnan(v_new)].any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("terminal", ["mixed", "all", "none"])
@pytest.mark.parametrize("E", [1, 3])
@pytest.mark.parametrize("f", [1, 37, 200])
def test_fused_event_commit_matches_jax_ref(f, E, terminal, dtype):
    *args, flags = EC.commit_inputs(f + E, 24, f, E, dtype, terminal)
    want = _jax(lambda: jref.fused_event_commit(*_jnp(args), terminal=flags), dtype)
    for fn in (tref.fused_event_commit, ops.fused_event_commit):
        got = fn(*EC.to_torch(args, "cpu"), terminal=flags)
        assert got[0].dtype == got[3].dtype == torch.bool and got[6].dtype == torch.int32
        _assert_outputs(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("E", EC.COMMIT_EVENTS)
@pytest.mark.parametrize("f", EC.COMMIT_WIDTHS)
def test_fused_event_commit_widths_match_jax_ref(f, E, dtype):
    """``fused_event_commit`` at the boundaries of the card kernel's layout
    (``event_checks.COMMIT_WIDTHS``: rows below, at and above a 16-byte
    chunk, whole 16-byte words or not; E = 1, 3, 64), with rows that detect
    no crossing, one, all at one x (a tie) and a random mix."""
    *args, flags = EC.commit_inputs(f + 7 * E, 13, f, E, dtype, "mixed", rows="classes")
    n = np.asarray(args[2]).sum(axis=1)
    assert (n[0::4] == 0).all() and (n[1::4] == 1).all() and (n[2::4] == E).all()
    want = _jax(lambda: jref.fused_event_commit(*_jnp(args), terminal=flags), dtype)
    for fn in (tref.fused_event_commit, ops.fused_event_commit):
        got = fn(*EC.to_torch(args, "cpu"), terminal=flags)
        _assert_outputs(got, want, dtype)
    # Every crossing of a tied row is recorded, and the first terminal one
    # (event 0 under "mixed") stops it with its state.
    assert (want[6][2::4] == E).all() and want[3][2::4].all()
    np.testing.assert_array_equal(want[5][2::4], args[1][2::4, 0])


def test_unaligned_commit_inputs_are_views_off_a_16_byte_boundary():
    t = torch.arange(12, dtype=torch.float32).view(3, 4)
    u = EC.unaligned(t)
    assert u.is_contiguous() and u.data_ptr() % 16 != 0 and torch.equal(u, t)
    *args, flags = EC.commit_inputs(3, 5, 4, 2, np.float64, rows="classes")
    cargs = list(EC.to_torch(args, "cpu"))
    want = tref.fused_event_commit(*cargs, terminal=flags)
    cargs[3], cargs[8] = EC.unaligned(cargs[3]), EC.unaligned(cargs[8])
    got = tref.fused_event_commit(*cargs, terminal=flags)
    assert EC.assert_bitwise("fused_event_commit", got, want) == 0.0


def test_commit_tie_goes_to_the_first_terminal_event():
    """Two terminal crossings at the same x: the first one's state stops the
    row (strict <), and both are recorded (x <= x_stop)."""
    x = torch.tensor([[0.25, 0.25]], dtype=torch.float64)
    y_ev = torch.tensor([[[1.0], [2.0]]], dtype=torch.float64)
    newly = torch.tensor([[True, True]])
    out = tref.fused_event_commit(
        x, y_ev, newly, torch.zeros(1, 1, dtype=torch.float64),
        torch.zeros(1, dtype=torch.float64), torch.ones(1, dtype=torch.float64),
        torch.zeros(1, 2, dtype=torch.bool), torch.full((1, 2), np.nan, dtype=torch.float64),
        torch.zeros(1, 2, 1, dtype=torch.float64), terminal=(True, True))
    assert out[5].item() == 1.0 and out[6].item() == 2 and out[4].item() == 0.25


# --------------------------------------------------------------------- (b)

class TestPallasInterpret:
    """One small case of each event op through the Pallas kernel in interpret
    mode (``tests/test_events.py``'s way), float32 at 1e-6, masks exactly."""

    @pytest.mark.parametrize("f", [37, 200])
    def test_masked_bisect_refine(self, f):
        args = EC.bisect_inputs(3 + f, 9, f, np.float32)
        want = _jax(lambda: pallas_impl.masked_bisect_refine(*_jnp(args), interpret=True),
                    np.float32)
        _assert_outputs(tref.masked_bisect_refine(*EC.to_torch(args, "cpu")), want,
                        np.float32)

    @pytest.mark.parametrize("b", [9, 37])
    def test_fused_event_detect(self, b):
        *args, dirs = EC.detect_inputs(b, b, 3, np.float32)
        want = _jax(lambda: pallas_impl.fused_event_detect(*_jnp(args), directions=dirs,
                                                           interpret=True), np.float32)
        _assert_outputs(tref.fused_event_detect(*EC.to_torch(args, "cpu"), directions=dirs),
                        want, np.float32)

    @pytest.mark.parametrize("f", [37, 200])
    def test_fused_event_commit(self, f):
        *args, flags = EC.commit_inputs(5 + f, 9, f, 3, np.float32)
        want = _jax(lambda: pallas_impl.fused_event_commit(*_jnp(args), terminal=flags,
                                                           interpret=True), np.float32)
        _assert_outputs(tref.fused_event_commit(*EC.to_torch(args, "cpu"), terminal=flags),
                        want, np.float32)

    @pytest.mark.parametrize("f, E", [(5, 64), (783, 3), (785, 1)])
    def test_fused_event_commit_widths(self, f, E):
        *args, flags = EC.commit_inputs(f + E, 9, f, E, np.float32, rows="classes")
        want = _jax(lambda: pallas_impl.fused_event_commit(*_jnp(args), terminal=flags,
                                                           interpret=True), np.float32)
        _assert_outputs(tref.fused_event_commit(*EC.to_torch(args, "cpu"), terminal=flags),
                        want, np.float32)


# --------------------------------------------------------------------- (c)

def _ns(lib, fused=False):
    """What a case needs from one framework: its core and array functions,
    the keywords of a solve call (``kw``) and of a driver (``drv``)."""
    if lib == "jax":
        return types.SimpleNamespace(core=J, stack=lambda xs: jnp.stack(xs, axis=-1),
                                     full_like=jnp.full_like, asarray=jnp.asarray, kw={},
                                     drv={})
    return types.SimpleNamespace(core=T, stack=lambda xs: torch.stack(xs, dim=-1),
                                 full_like=torch.full_like, asarray=torch.as_tensor,
                                 kw={"device": "cpu"}, drv={"fused": fused})


def _ball(xp):
    return lambda t, y, args: xp.stack((y[..., 1], xp.full_like(y[..., 1], -G)))


def _hit(h0, v0=0.0):
    return (v0 + np.sqrt(v0**2 + 2.0 * G * h0)) / G


def _ground(xp):
    return xp.core.Event(lambda t, y, args: y[0], terminal=True, direction=-1.0)


TIGHT = dict(rtol=1e-6, atol=1e-9)


def _solve(xp, y0, t_eval=None, f=None, **kw):
    f = _ball(xp) if f is None else f
    return xp.core.solve_ivp(f, y0, t_eval, **kw, **xp.kw, **xp.drv)


CASES = {
    "mixed_batch": lambda xp: _solve(
        xp, np.array([[10.0, 0.0], [5.0, 2.0], [20.0, -1.0], [500.0, 0.0]]),
        t_start=0.0, t_end=5.0, events=_ground(xp), **TIGHT),
    "zero_extra_vf": lambda xp: _solve(
        xp, np.array([[10.0, 0.0]]), t_start=0.0, t_end=1.2,
        events=xp.core.Event(lambda t, y, args: y[0] - 5.0, terminal=False), **TIGHT),
    "dense_truncated": lambda xp: _solve(
        xp, np.array([[10.0, 0.0], [200.0, 0.0]]), np.linspace(0.0, 3.0, 31),
        events=_ground(xp), **TIGHT),
    "terminal_beats_success": lambda xp: _solve(
        xp, np.array([[10.0, 0.0]]), t_start=0.0, t_end=_hit(10.0) + 1e-3,
        events=_ground(xp), **TIGHT),
    "backward_time": lambda xp: _solve(
        xp, np.array([[0.0, -G * _hit(10.0)]]), t_start=_hit(10.0), t_end=-1.0,
        events=xp.core.Event(lambda t, y, args: y[0] - 5.0, terminal=True), **TIGHT),
    **{f"direction_{name}": (lambda d: lambda xp: _solve(
        xp, np.array([[np.sin(0.5), np.cos(0.5)]]),
        f=lambda t, y, args: xp.stack((y[..., 1], -y[..., 0])), t_start=0.0, t_end=8.0,
        events=xp.core.Event(lambda t, y, args: y[0], terminal=True, direction=d),
        rtol=1e-7, atol=1e-9))(d) for name, d in (("falling", -1.0), ("rising", 1.0),
                                                    ("any", 0.0))},
    "non_terminal_first_crossing": lambda xp: _solve(
        xp, np.array([[10.0, 0.0]]), t_start=0.0, t_end=1.0,
        events=xp.core.Event(lambda t, y, args: y[1] + 5.0, terminal=False, direction=-1.0),
        **TIGHT),
    "crossings_after_terminal_discarded": lambda xp: _solve(
        xp, np.array([[10.0, 0.0]]), t_start=0.0, t_end=5.0,
        events=[_ground(xp), xp.core.Event(lambda t, y, args: y[1] + 15.0, terminal=False,
                                           direction=-1.0)], rtol=1e-3, atol=1e-6),
    "earliest_terminal_wins": lambda xp: _solve(
        xp, np.array([[10.0, 0.0]]), t_start=0.0, t_end=5.0,
        events=[_ground(xp), xp.core.Event(lambda t, y, args: y[1] + 5.0, terminal=True,
                                           direction=-1.0)], **TIGHT),
    "batched_no_args": lambda xp: _solve(
        xp, np.array([[10.0, 0.0], [3.0, 1.0]]), t_start=0.0, t_end=5.0,
        events=xp.core.Event(lambda t, y: y[:, 0], terminal=True, direction=-1.0,
                             batched=True, with_args=False), **TIGHT),
    "args_flow_through": lambda xp: _solve(
        xp, np.array([[10.0, 0.0]]), t_start=0.0, t_end=5.0, args=4.0,
        events=xp.core.Event(lambda t, y, args: y[0] - args, terminal=True, direction=-1.0),
        **TIGHT),
    "success_and_event": lambda xp: _solve(
        xp, np.array([[10.0, 0.0], [200.0, 0.0]]), t_start=0.0, t_end=3.0,
        events=_ground(xp), **TIGHT),
    "no_dense_no_t_eval": lambda xp: _solve(
        xp, np.array([[10.0, 0.0], [3.0, 1.0]]), dense=False, t_start=0.0, t_end=5.0,
        events=[_ground(xp), xp.core.Event(lambda t, y, args: y[1] + 2.0, terminal=False)],
        **TIGHT),
    "no_dense_with_t_eval": lambda xp: _solve(
        xp, np.array([[10.0, 0.0], [3.0, 1.0]]), np.linspace(0.0, 2.0, 9), dense=False,
        events=_ground(xp), **TIGHT),
    "pytree_state": lambda xp: xp.core.AutoDiffAdjoint(
        "tsit5", events=xp.core.Event(lambda t, y, args: y["h"][0], terminal=True,
                                      direction=-1.0), **TIGHT, **xp.drv).solve(
        lambda t, y, args: {"h": y["v"], "v": xp.full_like(y["v"], -G)},
        {"h": xp.asarray(np.array([[10.0], [4.0]])), "v": xp.asarray(np.zeros((2, 1)))},
        None, t_start=0.0, t_end=5.0, **xp.kw),
    "reached_time_early_stop": lambda xp: _solve(
        xp, np.array([[1.0], [0.1]]), f=lambda t, y, args: y * y, t_start=0.0, t_end=2.0,
        max_steps=5000),
    "reached_time_max_steps": lambda xp: _solve(
        xp, np.array([[2.0, 0.0]]), f=lambda t, y, mu: xp.stack(
            (y[..., 1], mu * (1 - y[..., 0] ** 2) * y[..., 1] - y[..., 0])),
        t_start=0.0, t_end=100.0, args=50.0, max_steps=10),
}


@functools.lru_cache(maxsize=None)
def _jax_solution(case):
    with jax.enable_x64(True):
        return jax.tree_util.tree_map(np.asarray, CASES[case](_ns("jax")))


def _flat(x):
    if isinstance(x, dict):
        return {k: _flat(v) for k, v in x.items()}
    return None if x is None else _np(x)


def _assert_solutions_close(got, want):
    np.testing.assert_array_equal(_np(got.status), want.status)
    for k in ("n_steps", "n_events", "n_f_evals", "n_initialized"):
        if k in want.stats:
            np.testing.assert_array_equal(_np(got.stats[k]), want.stats[k], err_msg=k)
    assert ("n_events" in got.stats) == ("n_events" in want.stats)
    for name in ("ts", "ys", "event_t", "event_y"):
        g, w = _flat(getattr(got, name)), getattr(want, name)
        if w is None:
            assert g is None, name
            continue
        for gk, wk in (zip(g.values(), w.values()) if isinstance(w, dict) else [(g, w)]):
            assert gk.dtype == np.float64, name
            np.testing.assert_allclose(gk, np.asarray(wk), rtol=1e-9, atol=1e-9, err_msg=name)
    if want.event_mask is None:
        assert got.event_mask is None
    else:
        np.testing.assert_array_equal(_np(got.event_mask), want.event_mask)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_matches_jax_float64(case, fused):
    _assert_solutions_close(CASES[case](_ns("torch", fused)), _jax_solution(case))


class TestSemantics:
    """The assertions of ``tests/test_events.py`` on the port's own solves."""

    def _sol(self, case, fused=False):
        return CASES[case](_ns("torch", fused))

    def test_mixed_batch_localization_accuracy(self):
        sol = self._sol("mixed_batch")
        h0, v0 = np.array([10.0, 5.0, 20.0]), np.array([0.0, 2.0, -1.0])
        assert sol.status.tolist() == [T.Status.EVENT] * 3 + [T.Status.SUCCESS]
        np.testing.assert_allclose(sol.event_t[:3, 0].numpy(), _hit(h0, v0), rtol=1e-5)
        assert np.isnan(sol.event_t[3, 0].item()) and not sol.event_mask[3, 0]
        np.testing.assert_allclose(sol.ts[:3].numpy(), sol.event_t[:3, 0].numpy())
        np.testing.assert_allclose(sol.ys[:3, 0].numpy(), 0.0, atol=1e-5)

    def test_zero_extra_vf_evaluations(self):
        sol = self._sol("zero_extra_vf")
        plain = T.solve_ivp(_ball(_ns("torch")), np.array([[10.0, 0.0]]), t_start=0.0,
                            t_end=1.2, device="cpu", **TIGHT)
        assert sol.stats["n_events"].item() == 1
        assert torch.equal(sol.stats["n_f_evals"], plain.stats["n_f_evals"])
        assert torch.equal(sol.stats["n_steps"], plain.stats["n_steps"])

    def test_dense_output_truncated_past_event(self):
        sol = self._sol("dense_truncated", fused=True)
        n_pre = int((np.linspace(0.0, 3.0, 31) <= _hit(10.0)).sum())
        assert sol.stats["n_initialized"].tolist() == [n_pre, 31]
        assert bool((sol.ys[0, n_pre:] == 0.0).all())

    def test_crossings_after_terminal_and_earliest_wins(self):
        late = self._sol("crossings_after_terminal_discarded")
        assert late.event_mask[0].tolist() == [True, False]
        assert late.stats["n_events"].item() == 1
        early = self._sol("earliest_terminal_wins")
        np.testing.assert_allclose(early.ts[0].item(), 5.0 / G, rtol=1e-5)
        assert early.event_mask[0].tolist() == [False, True]

    def test_event_stop_counts_as_success(self):
        sol = self._sol("success_and_event")
        assert sol.status.tolist() == [T.Status.EVENT, T.Status.SUCCESS]
        assert bool(sol.success.all())

    def test_no_events_leaves_the_fields_empty(self):
        sol = _solve(_ns("torch"), np.array([[10.0, 0.0]]), t_start=0.0, t_end=0.5)
        assert sol.event_t is None and sol.event_y is None and sol.event_mask is None
        assert "n_events" not in sol.stats

    def test_pytree_event_y_has_the_callers_structure(self):
        sol = self._sol("pytree_state")
        assert set(sol.event_y) == {"h", "v"} and tuple(sol.event_y["h"].shape) == (2, 1, 1)
        np.testing.assert_allclose(sol.event_y["h"][:, 0, 0].numpy(), 0.0, atol=1e-5)

    def test_pytree_batched_condition_rejected(self):
        drv = T.AutoDiffAdjoint("tsit5", events=T.Event(lambda t, y, args: y, batched=True))
        with pytest.raises(ValueError, match="batched event conditions"):
            drv.solve(lambda t, y, args: y, {"h": torch.ones(1, 1)}, None, t_start=0.0,
                      t_end=1.0, device="cpu")

    @pytest.mark.parametrize("fused", [False, True])
    def test_make_solver_triple_threads_events(self, fused):
        init, body, finish = T.make_solver(_ball(_ns("torch")), rtol=1e-6, atol=1e-9,
                                           events=_ground(_ns("torch")), fused=fused)
        state, consts = init(torch.tensor([[10.0, 0.0]], dtype=torch.float64), None, 0.0, 5.0)
        for _ in range(1000):
            if not bool(state.running.any()):
                break
            state = body(state, consts, None)
        sol = finish(state, consts)
        with jax.enable_x64(True):
            want = J.make_solver(_ball(_ns("jax")), rtol=1e-6, atol=1e-9,
                                 events=_ground(_ns("jax")))
            jstate, jconsts = want[0](jnp.asarray([[10.0, 0.0]]), None, 0.0, 5.0, None, None)
            jstate = jax.lax.while_loop(lambda s: jnp.any(s.running) & (s.it < 1000),
                                        lambda s: want[1](s, jconsts, None), jstate)
            jsol = jax.tree_util.tree_map(np.asarray, want[2](jstate, jconsts))
        assert sol.status.item() == T.Status.EVENT == int(jsol.status[0])
        np.testing.assert_allclose(sol.event_t.numpy(), jsol.event_t, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(sol.event_t[0, 0].item(), _hit(10.0), rtol=1e-5)

    def test_event_spec_is_hashable_and_normalized(self):
        cond = lambda t, y, args: y[0]  # noqa: E731
        assert T.Event(cond) == T.Event(cond) and hash(T.Event(cond)) == hash(T.Event(cond))
        from repro_torch.core.events import normalize_events
        assert normalize_events(None) == () and normalize_events(T.Event(cond)) == (T.Event(cond),)
        with pytest.raises(TypeError, match="expected Event"):
            normalize_events([cond])

    def test_to_numpy_carries_the_event_fields(self):
        sol = convert.to_numpy(self._sol("mixed_batch"))
        assert isinstance(sol.event_t, np.ndarray) and sol.event_t.shape == (4, 1)
        assert sol.event_y.shape == (4, 1, 2) and sol.event_mask.dtype == np.bool_


# --------------------------------------------------------------------- (d)

def _vdp(t, y, mu):
    return torch.stack((y[:, 1], mu * (1 - y[:, 0] ** 2) * y[:, 1] - y[:, 0]), dim=-1)


def _bitwise_kw(name, term_kind, dense):
    """The solves of ``test_torch_fused.py``'s bitwise matrix, with a terminal
    and a non-terminal event that fire in some rows and not in others."""
    tab = T.get_tableau(name)
    kw = dict(method=name, device="cpu", dense=dense)
    if tab.b_err is None:
        kw.update(controller=T.FixedController(), dt0=0.05)
    else:
        kw.update(controller=T.pid_controller(), atol=1e-5, rtol=1e-5)
    if term_kind == "vf":
        rng = np.random.default_rng(0)
        y0 = (np.array([2.0, 0.0]) + 0.1 * rng.standard_normal((8, 2))).astype(np.float32)
        events = (T.Event(lambda t, y, args: y[0], terminal=False),
                  T.Event(lambda t, y, args: y[1] + 2.0 + 0.1 * y[0], direction=-1.0))
        return _vdp, y0, np.linspace(0.0, 3.0, 13, dtype=np.float32), dict(
            kw, args=2.0, events=events)
    y0 = np.linspace(0.5, 1.5, 12, dtype=np.float32).reshape(4, 3)
    term = T.polynomial_term(0.0, (1.0, 0.5, 0.25), -1.0)
    events = (T.Event(lambda t, y, args: y[0] - 0.9, terminal=False),
              T.Event(lambda t, y, args: y[1] - 0.95, direction=1.0))
    return term, y0, np.linspace(0.0, 2.0, 9, dtype=np.float32), dict(kw, events=events)


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "final_state"])
@pytest.mark.parametrize("term_kind", ["vf", "poly"])
@pytest.mark.parametrize("name", EXPLICIT)
def test_fused_solve_with_events_bitwise_equals_unfused(name, term_kind, dense):
    f, y0, te, kw = _bitwise_kw(name, term_kind, dense)
    if not dense:
        te, kw = None, dict(kw, t_start=0.0, t_end=float(2.0 if term_kind == "poly" else 3.0))
    unfused = T.solve_ivp(f, y0, te, **kw)
    fused = T.solve_ivp(f, y0, te, fused=True, **kw)
    assert torch.equal(fused.stats.pop("n_fused_steps"), fused.stats["n_steps"])
    fused.stats.pop("fused_fallback_reason")
    assert bool(unfused.event_mask.any()) and not bool(unfused.event_mask.all())
    for name_ in ("ts", "ys", "status", "event_t", "event_y", "event_mask"):
        assert torch.equal(getattr(fused, name_).nan_to_num(-7.0)
                           if name_ == "event_t" else getattr(fused, name_),
                           getattr(unfused, name_).nan_to_num(-7.0)
                           if name_ == "event_t" else getattr(unfused, name_)), name_
    assert fused.stats.keys() == unfused.stats.keys()
    for k in unfused.stats:
        assert torch.equal(fused.stats[k], unfused.stats[k]), k


# --------------------------------------------------------------------- (e)

@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_bouncing_ball_four_bounces(fused):
    """``examples/bouncing_ball.py``: four terminal impacts per ball with the
    velocity reflected outside the solver; the k-th impact lands at
    sqrt(2 h0 / g) * (1 + 2 sum_{j=1..k} r^j)."""
    ns = _ns("torch")
    h0 = np.array([10.0, 10.0, 4.0, 1.0])
    restitution = np.array([0.9, 0.5, 0.7, 0.8])
    y = torch.tensor(np.stack([h0, np.zeros_like(h0)], 1), dtype=torch.float32)
    t = torch.zeros(4)
    impacts = []
    for _ in range(4):
        sol = T.solve_ivp(_ball(ns), y, None, t_start=t, t_end=t + 10.0,
                          events=_ground(ns), fused=fused, device="cpu", **TIGHT)
        assert bool((sol.status == T.Status.EVENT).all())
        t = sol.ts
        impacts.append(t.numpy())
        y = torch.stack([torch.zeros(4), -torch.as_tensor(restitution,
                                                          dtype=torch.float32) * sol.ys[:, 1]], 1)
    powers = restitution[:, None] ** np.arange(1, 4)[None, :]
    expect = np.sqrt(2.0 * h0 / G)[:, None] * np.concatenate(
        [np.ones((4, 1)), 1.0 + 2.0 * np.cumsum(powers, axis=1)], axis=1)
    assert np.abs(np.stack(impacts, 1) - expect).max() < 1e-3


class TestGolden:
    """``tests/test_events_golden.py``: scipy's ``solve_ivp`` and the analytic
    values at matched tolerances, float32 as there."""

    H0, V0 = np.array([10.0, 5.0, 20.0]), np.array([0.0, 2.0, -1.0])

    @pytest.fixture(autouse=True)
    def _scipy(self):
        self.si = pytest.importorskip("scipy.integrate")

    def test_ball_terminal_times_match_scipy_and_analytic(self):
        ns = _ns("torch")
        sol = _solve(ns, np.stack([self.H0, self.V0], 1).astype(np.float32), t_start=0.0,
                     t_end=5.0, events=_ground(ns), **TIGHT)
        ground = lambda t, y: y[0]  # noqa: E731
        ground.terminal, ground.direction = True, -1.0
        scipy_t = [self.si.solve_ivp(lambda t, y: [y[1], -G], (0.0, 5.0), [h, v],
                                     events=ground, **TIGHT).t_events[0][0]
                   for h, v in zip(self.H0, self.V0)]
        np.testing.assert_allclose(sol.event_t[:, 0].numpy(), _hit(self.H0, self.V0),
                                   rtol=1e-5)
        np.testing.assert_allclose(sol.event_t[:, 0].numpy(), scipy_t, rtol=1e-5)
        assert bool((sol.status == T.Status.EVENT).all())

    def test_ball_dense_output_matches_scipy(self):
        t_eval = np.linspace(0.0, 1.2, 25)
        ours = _solve(_ns("torch"), np.stack([self.H0, self.V0], 1).astype(np.float32),
                      t_eval.astype(np.float32), **TIGHT)
        for i, (h, v) in enumerate(zip(self.H0, self.V0)):
            res = self.si.solve_ivp(lambda t, y: [y[1], -G], (0.0, 1.2), [h, v],
                                    t_eval=t_eval, **TIGHT)
            np.testing.assert_allclose(ours.ys[i].numpy(), res.y.T, rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("terminal", [True, False])
    def test_threshold_exponential(self, terminal):
        a, y0, th = 0.9, np.array([0.5, 1.0, 2.0]), 6.0
        ev = T.Event(lambda t, y, args: y[0] - th, terminal=terminal, direction=1.0)
        sol = T.solve_ivp(lambda t, y, args: args * y, y0[:, None].astype(np.float32), None,
                          t_start=0.0, t_end=6.0, events=ev, args=a, device="cpu", **TIGHT)
        analytic = np.log(th / y0) / a
        np.testing.assert_allclose(sol.event_t[:, 0].numpy(), analytic, rtol=1e-5)
        if terminal:
            cross = lambda t, y: y[0] - th  # noqa: E731
            cross.terminal, cross.direction = True, 1.0
            scipy_t = [self.si.solve_ivp(lambda t, y: [a * y[0]], (0.0, 6.0), [v],
                                         events=cross, **TIGHT).t_events[0][0] for v in y0]
            np.testing.assert_allclose(sol.event_t[:, 0].numpy(), scipy_t, rtol=1e-5)
            np.testing.assert_allclose(sol.event_y[:, 0, 0].numpy(), th, rtol=1e-5)
        else:
            assert bool((sol.status == T.Status.SUCCESS).all())
            np.testing.assert_allclose(sol.ys[:, 0].numpy(), y0 * np.exp(a * 6.0), rtol=1e-4)


class TestNoHiddenFallback:
    def test_cuda_wrappers_refuse_cpu_tensors(self):
        before = dict(ops.launches)
        args = EC.to_torch(EC.bisect_inputs(0, 3, 2, np.float32), "cpu")
        with pytest.raises(ValueError, match="CUDA tensors"):
            cuda_impl.masked_bisect_refine(*args)
        *dargs, dirs = EC.to_torch(EC.detect_inputs(0, 3, 2, np.float32), "cpu")
        with pytest.raises(ValueError, match="CUDA tensors"):
            cuda_impl.fused_event_detect(*dargs, directions=dirs)
        *cargs, flags = EC.to_torch(EC.commit_inputs(0, 3, 2, 2, np.float32), "cpu")
        with pytest.raises(ValueError, match="CUDA tensors"):
            cuda_impl.fused_event_commit(*cargs, terminal=flags)
        assert ops.launches == before

    def test_event_flags_for_the_parameter_block(self):
        """Directions ride as their sign and terminal flags as 0/1 (int8);
        more than the kernels' 64 events raise."""
        lib = types.SimpleNamespace(rt_max_events=lambda: 64)
        flags, E = cuda_impl._event_flags("x", (True, False, True), lib)
        assert list(flags) == [1, 0, 1] and E == 3
        flags, E = cuda_impl._event_flags("x", (0.0, -1.0, 2.5), lib)
        assert list(flags) == [0, -1, 1] and E == 3
        with pytest.raises(ValueError, match="1 to 64 events"):
            cuda_impl._event_flags("x", (1.0,) * 65, lib)

    def test_unknown_device_raises(self):
        col = torch.ones(2, 1, device="meta")
        with pytest.raises(ValueError, match="no implementation"):
            ops.fused_event_detect(col, col, col.bool(), col[:, 0].bool(), directions=(0.0,))
