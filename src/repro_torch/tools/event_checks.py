"""Inputs that hold the event kernels (``masked_bisect_refine``,
``fused_event_detect``, ``fused_event_commit``) to their plain versions, made
with numpy from a seed so that the JAX package's ops, the port's plain ops
and the CUDA kernels can all be fed the same numbers.  ``chip_smoke.py``,
``tests/test_torch_kernels_card.py`` and ``tests/test_torch_events.py`` use
them.

Each input function covers the cases the kernels must get right in one batch:

- ``bisect_inputs``: active, inactive or mixed rows (``active``), brackets
  inside [0, 1], condition values of both signs, exact zeros and NaNs;
- ``detect_inputs``: every direction (the ``directions`` cycle 0, +1, -1),
  values of both signs, zero (+0.0 and -0.0) at either or both endpoints,
  NaNs, already fired cells and rejected rows;
- ``commit_inputs``: terminal and non-terminal mixes (``terminal``), rows
  with no crossing, one or several, two terminal crossings at the same x (a
  tie), crossings after the earliest terminal one, already fired cells and
  NaN event times where nothing was recorded yet; with ``rows="classes"``
  every fourth row also detects no crossing, one, or all E at one x (all
  recorded, the first terminal one stops the row).

``COMMIT_WIDTHS`` and ``COMMIT_EVENTS`` are the widths and event counts at
the boundaries of ``fused_event_commit``'s layout on the card (a thread per
16-byte chunk of a row where the planes start 16-byte aligned and a row is a
whole number of 16-byte words, entry by entry otherwise); ``unaligned``
gives a tensor's copy one entry past a 16-byte boundary.

All three kernels are elementwise selections and single-rounded ATen
operations in their plain versions, so on the card they are held bitwise
(``assert_bitwise``).
"""

from __future__ import annotations

import numpy as np
import torch

DIRECTIONS = (0.0, 1.0, -1.0)
# f = 1-5 (below, at and just above a 16-byte chunk in either dtype) and
# full_width's 784 with its neighbours: rows of whole 16-byte words in
# float32 at f = 4, 784, in float64 at f = 2, 4, 784; the rest not.
COMMIT_WIDTHS = (1, 2, 3, 4, 5, 783, 784, 785)
COMMIT_EVENTS = (1, 3, 64)  # one event, a few, kMaxEvents


def _signed(rng, shape, dtype, zero=0.15, nan=0.05):
    """Normal draws with a share of exact zeros and NaNs."""
    v = rng.standard_normal(shape)
    u = rng.uniform(size=shape)
    v[u < zero] = 0.0
    v[(u >= zero) & (u < zero + nan)] = np.nan
    return v.astype(dtype)


def bisect_inputs(seed, b, f, dtype, active="mixed"):
    """``(coeffs, lo, hi, v_lo, v_mid, active)`` as numpy arrays;
    ``active`` is "mixed", "all" or "none"."""
    rng = np.random.default_rng(seed)
    coeffs = tuple(rng.standard_normal((b, f)).astype(dtype) for _ in range(4))
    lo = rng.uniform(0.0, 0.4, b).astype(dtype)
    hi = rng.uniform(0.6, 1.0, b).astype(dtype)
    mask = {"mixed": rng.uniform(size=b) > 0.4, "all": np.ones(b, bool),
            "none": np.zeros(b, bool)}[active]
    return coeffs, lo, hi, _signed(rng, b, dtype), _signed(rng, b, dtype), mask


def detect_inputs(seed, b, E, dtype):
    """``(v_prev, v_new, fired, accept, directions)``; the directions cycle
    through 0, +1, -1 over the E events."""
    rng = np.random.default_rng(seed)
    v_prev, v_new = _signed(rng, (b, E), dtype), _signed(rng, (b, E), dtype)
    both = rng.uniform(size=(b, E)) < 0.05  # zero at both endpoints: never fires
    v_prev[both] = v_new[both] = 0.0
    fired = rng.uniform(size=(b, E)) < 0.2
    accept = rng.uniform(size=b) > 0.25
    directions = tuple(DIRECTIONS[i % 3] for i in range(E))
    negative = rng.uniform(size=(2, b, E)) < 0.5  # half of the zeros are -0.0
    v_prev[(v_prev == 0) & negative[0]] = -0.0
    v_new[(v_new == 0) & negative[1]] = -0.0
    return v_prev, v_new, fired, accept, directions


def commit_inputs(seed, b, f, E, dtype, terminal="mixed", rows="random"):
    """``(x, y_ev, newly, y_new, t0, dt, fired, ev_t, ev_y, terminal)``;
    ``terminal`` is "mixed" (alternating, from True), "all" or "none";
    ``rows`` "random" (each crossing detected with probability 1/2) or
    "classes": rows 0, 4, 8, ... detect no crossing, rows 1, 5, ... exactly
    one, rows 2, 6, ... all E at one x (so all are recorded, and among
    terminal ones the first wins the tie), the rest as "random"."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (b, E)).astype(dtype)
    if E > 1:
        tie = rng.uniform(size=b) < 0.2  # two crossings at the same x
        x[tie, 1] = x[tie, 0]
        if E > 2:
            x[tie, 2] = x[tie, 0]
    newly = rng.uniform(size=(b, E)) < 0.5
    fired = ~newly & (rng.uniform(size=(b, E)) < 0.3)
    t0 = rng.uniform(-1.0, 1.0, b).astype(dtype)
    dt = (rng.choice([-1.0, 1.0], b) * rng.uniform(0.01, 0.5, b)).astype(dtype)
    ev_t = np.where(fired, rng.uniform(-2.0, 2.0, (b, E)), np.nan).astype(dtype)
    y_ev = rng.standard_normal((b, E, f)).astype(dtype)
    y_new = rng.standard_normal((b, f)).astype(dtype)
    ev_y = np.where(fired[:, :, None], rng.standard_normal((b, E, f)), 0.0).astype(dtype)
    flags = tuple({"mixed": i % 2 == 0, "all": True, "none": False}[terminal]
                  for i in range(E))
    if rows == "classes":
        cls = np.arange(b) % 4
        newly[cls == 0] = False
        one = np.flatnonzero(cls == 1)
        newly[one] = False
        newly[one, rng.integers(0, E, one.size)] = True
        newly[cls == 2] = True
        x[cls == 2] = x[cls == 2, :1]
        fired &= ~newly
        ev_t = np.where(fired, ev_t, np.nan).astype(dtype)
        ev_y = np.where(fired[:, :, None], ev_y, 0.0).astype(dtype)
    elif rows != "random":
        raise ValueError(f"rows is 'random' or 'classes', got {rows!r}")
    return x, y_ev, newly, y_new, t0, dt, fired, ev_t, ev_y, flags


def unaligned(t):
    """A contiguous copy of ``t`` that starts one entry past a 16-byte
    boundary (a view into a buffer one entry longer)."""
    flat = torch.empty(t.numel() + 1 + 16 // t.element_size(), dtype=t.dtype, device=t.device)
    shift = (-flat.data_ptr() // t.element_size()) % (16 // t.element_size()) + 1
    view = flat[shift:shift + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 != 0
    return view


def to_torch(arrays, device):
    """numpy arrays -> tensors on ``device`` (other items pass as they are)."""
    return tuple(
        torch.as_tensor(a, device=device) if isinstance(a, np.ndarray)
        else tuple(torch.as_tensor(c, device=device) for c in a)
        if isinstance(a, tuple) and a and isinstance(a[0], np.ndarray) else a
        for a in arrays)


def assert_bitwise(name, got, want):
    """Every output equal, NaN where NaN; returns the largest absolute
    difference over the floating outputs (0.0 when bitwise equal)."""
    worst = 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True,
                                   msg=lambda m, k=k: f"{name} output {k}: {m}")
        if g.is_floating_point():
            d = (g.double() - w.double()).abs().nan_to_num(0.0)
            worst = max(worst, float(d.max()) if d.numel() else 0.0)
    return worst
