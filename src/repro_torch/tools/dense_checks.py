"""Inputs at the boundaries of the layouts of ``error_norm``,
``interp_eval`` and ``fused_update`` on the card, made with numpy from a seed
so that the JAX package's ops, the port's plain ops and the CUDA kernels can
all be fed the same numbers.  ``chip_smoke.py``,
``tests/test_torch_kernels_card.py``, ``tests/test_torch_dense_widths.py``
and ``tests/test_torch_update_widths.py`` use them.

- ``ERROR_NORM_WIDTHS``: one entry; two (vdp_table3); 16 and 17 (rows that
  share a block, in whole 16-byte chunks or not); around a warp (31-33);
  around full_width's 784 (whole 16-byte chunks in both dtypes, or not).  The fused
  step tests' widths lack 16, 17, 31, 33 and 783.  ``interp_eval`` is held
  at the same widths.
- ``NORM_WIDE_WIDTHS`` x ``NORM_WIDE_ROWS``: the rows of ``error_norm``'s
  wide body, held bitwise to its warp body on the card.
- ``TOL_KINDS``: a scalar, a (b,) and a (b, f) tolerance pair.
- ``MASK_KINDS``: no masked cell, one point a row, every point, three
  consecutive points a row (as a step writes the dense output), and the
  same runs on some rows only, between rows with no masked cell.
- ``UPDATE_SHAPES``: ``fused_update``'s (b, f): one entry a row (rows sharing
  a block), vdp_table3's two, three, a warp's chunks and one more (33),
  around full_width's 784, and a row wider than a block (5000).
- ``UPDATE_WEIGHTS``: every tableau's own (b_sol, b_err), zero weights
  included (a fixed-step tableau's error weights are all zero, as the
  stepper passes them), and random weights at every stage count 1..8.
"""

from __future__ import annotations

import numpy as np

from ..core.tableau import TABLEAUS

ERROR_NORM_WIDTHS = (1, 2, 16, 17, 31, 32, 33, 783, 784, 785)
# error_norm's wide body (rows wider than NORM_ROW_MAX_F): one entry past
# the row body's widest, whole 16-byte chunks in both dtypes or not, and up
# to a million entries, at b = 1, 2 and 37 rows.
NORM_WIDE_WIDTHS = (4097, 8192, 9001, 65537, 1000003, 1000004)
NORM_WIDE_ROWS = (1, 2, 37)
TOL_KINDS = ("scalar", "row", "full")
MASK_KINDS = ("none", "one", "all", "run3", "some_rows")
UPDATE_SHAPES = ((5, 1), (300, 2), (37, 3), (37, 33), (37, 783), (37, 784), (37, 785),
                 (3, 5000))
UPDATE_WEIGHTS = tuple(TABLEAUS) + tuple(f"s={s}" for s in range(1, 9))


def norm_inputs(seed, b, f, dtype, tol_kind):
    """``(err, y0, y1, atol, rtol)``: numpy arrays, and Python floats for a
    scalar tolerance pair."""
    rng = np.random.default_rng(seed)
    err = (1e-4 * rng.standard_normal((b, f))).astype(dtype)
    y0, y1 = (rng.standard_normal((b, f)).astype(dtype) for _ in range(2))
    if tol_kind == "scalar":
        return err, y0, y1, 1e-4, 1e-3
    shape = (b,) if tol_kind == "row" else (b, f)
    return (err, y0, y1, rng.uniform(1e-6, 1e-3, shape).astype(dtype),
            rng.uniform(1e-5, 1e-2, shape).astype(dtype))


def interp_mask(seed, b, n, kind):
    """A (b, n) bool mask of ``MASK_KINDS``' ``kind``."""
    rng = np.random.default_rng(seed)
    cols = np.arange(n)[None]
    if kind == "none":
        return np.zeros((b, n), bool)
    if kind == "all":
        return np.ones((b, n), bool)
    if kind == "one":
        return cols == rng.integers(0, n, (b, 1))
    start = rng.integers(0, max(n - 2, 1), (b, 1))
    run = (cols >= start) & (cols < start + 3)
    if kind == "run3":
        return run
    if kind == "some_rows":
        return run & (rng.random((b, 1)) < 0.4)
    raise ValueError(f"unknown mask kind {kind!r}; one of {MASK_KINDS}")


def interp_inputs(seed, b, n, f, dtype, kind):
    """``(coeffs, x, mask, out)``: four (b, f) coefficient planes, (b, n)
    positions in [0, 1], a ``kind`` mask and a (b, n, f) buffer."""
    rng = np.random.default_rng(seed)
    coeffs = tuple(rng.standard_normal((b, f)).astype(dtype) for _ in range(4))
    x = rng.uniform(0.0, 1.0, (b, n)).astype(dtype)
    out = rng.standard_normal((b, n, f)).astype(dtype)
    return coeffs, x, interp_mask(seed + 1, b, n, kind), out


def update_weights(kind):
    """``(b_sol, b_err)``, float64, of ``UPDATE_WEIGHTS``' ``kind``: a
    tableau's name or ``"s=<count>"``."""
    if kind in TABLEAUS:
        tab = TABLEAUS[kind]
        b_sol = np.asarray(tab.b_sol, dtype=np.float64)
        b_err = (np.zeros(tab.stages) if tab.b_err is None
                 else np.asarray(tab.b_err, dtype=np.float64))
        return b_sol, b_err
    s = int(kind.removeprefix("s="))
    rng = np.random.default_rng(s)
    return rng.standard_normal(s), rng.standard_normal(s)


def update_inputs(seed, b, f, s, dtype):
    """``(y, K, dt)``: a (b, f) state, (s, b, f) stages and (b,) steps of
    either sign."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, f)).astype(dtype),
            rng.standard_normal((s, b, f)).astype(dtype),
            rng.uniform(-0.5, 0.5, b).astype(dtype))
