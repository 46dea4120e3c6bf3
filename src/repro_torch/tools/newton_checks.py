"""Inputs that hold the chord-Newton kernels (``batched_lu_factor``,
``batched_linsolve``, ``fused_newton_iter``, ``masked_newton_update``) to
their plain versions, made with numpy from a seed so that the JAX package's
ops, the port's plain ops and the CUDA kernels can all be fed the same
numbers.  ``chip_smoke.py``, ``tests/test_torch_kernels_card.py`` and
``tests/test_torch_stiff.py`` use them.

``chord_matrices`` makes the matrices the stiff path factors, ``M = I -
h*gamma*J``, one per instance, in four kinds:

- ``"chord"``: J = -diag(d) + coupling, with a stiffness spread d in
  [1, 1000] and h*gamma in [0.01, 1], so M = diag(1 + h*gamma*d)(I - C) with
  ||C|| about 0.6: well conditioned (at b = 1024 the condition numbers of
  every kind stay below 3e3, so a float32 solve is good to ~2e-6 of its
  largest entry).  Its rows are shuffled, so partial pivoting has to
  find each pivot, and the pivots' magnitudes are distinct (the diagonal
  dominates its column by far): the permutation is fixed by the data, not by
  rounding, and equal across implementations.
- ``"zero_diag"``: the unshuffled chord matrix with rows 0 and 1 swapped
  and a zero leading diagonal (f >= 2): a row swap in the first column, and
  the matrix stays as well conditioned as the chord matrix.
- ``"ties"``: the unshuffled chord matrix with a fixed, well-conditioned
  leading 3 x 3 block (``TIE_BLOCK``) that ties magnitudes in the first
  column (f >= 3): rows 1 and 2 both hold the largest |entry| (3 and -3, the
  first of them wins, as in LAPACK's i?amax and the Pallas kernel's first
  match), and in half the instances row 0 ties with them (row 0 wins, no
  swap).
- ``"nan"``: chord matrices with one NaN entry in every third instance;
  the kernels must finish and give a non-finite ``res_norm`` on those rows
  (``newton_solve`` then marks them diverged), and the other rows must match.

``wide_inputs`` makes the chord kind on the card, with torch, for the widths
(f in the thousands) that hold the kernels above their old 48 KiB
shared-memory limit, where a numpy build would take gigabytes of host
memory.

``newton_inputs`` adds the vectors of one Newton iteration: a right-hand side,
an iterate ``k`` and its evaluation ``fk``, an ``active`` mask ("mixed",
"all" or "none") and a positive (b, f) error scale.

``UPDATE_WIDTHS`` are the widths at the boundaries of
``masked_newton_update``'s layout on the card: a warp per row, each lane
loading four of its columns (c = lane, lane + 32, ...; ``kNormBatch`` in
``csrc/linalg_common.cuh``) before using them, so 128 columns a batch: one
column, fewer and more columns than lanes, one batch and its neighbours,
two batches and theirs, and widths that are not a multiple of a batch.

The kernels eliminate in another order than LAPACK/cuSOLVER, so they are
held to the plain versions at a tolerance (``tolerance``): the LU relative
to the matrix's max-abs entry, the solutions and norms relative to their own
magnitude, and the permutation exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from .event_checks import to_torch  # noqa: F401  (re-exported for the callers)

KINDS = ("chord", "zero_diag", "ties", "nan")
# The leading 3 x 3 block of the "ties" kind: |3| three times in column 0
# (row 0 holds 0.5 instead in every other instance), well conditioned either
# way (condition numbers 3.3 and 13).
TIE_BLOCK = np.array([[3.0, -0.1, 0.1], [3.0, 4.5, 0.5], [-3.0, 0.5, 4.5]])
WIDTHS = (1, 3, 5, 33, 128)
UPDATE_WIDTHS = (1, 2, 31, 32, 33, 100, 127, 128, 129, 255, 256, 257)


def tolerance(dtype) -> float:
    """float32 1e-5, float64 1e-12: the elimination and substitution orders
    of the kernel and of LAPACK/cuSOLVER differ, and a backward-stable LU of a
    well-conditioned matrix rounds apart by a few ulps of the matrix's
    largest entry per entry (sqrt(f) eps at f = 128 is 7e-7 in float32,
    1.3e-15 in float64): the tolerances leave an order of magnitude."""
    return 1e-5 if dtype in (np.float32, torch.float32) else 1e-12


def chord_matrices(seed, b, f, dtype, kind="chord"):
    """(b, f, f) chord matrices M = I - h*gamma*J of ``kind`` (see the
    module docstring) as a numpy array of ``dtype``."""
    rng = np.random.default_rng(seed)
    hg = 10.0 ** rng.uniform(-2.0, 0.0, (b, 1))
    d = 10.0 ** rng.uniform(0.0, 3.0, (b, f))
    D = 1.0 + hg * d  # the diagonal of I - h*gamma*(-diag(d))
    if kind == "ties":
        D[:, :3] = 3.0  # rows 0-2 on the scale of the tie block
    G = rng.standard_normal((b, f, f)) * (0.3 / np.sqrt(f))
    np.einsum("bii->bi", G)[...] = 0.0
    M = D[:, :, None] * (np.eye(f) - G)
    if kind == "chord":
        order = np.argsort(rng.uniform(size=(b, f)), axis=1)
        M = np.take_along_axis(M, order[:, :, None], axis=1)
    elif kind == "zero_diag":
        if f < 2:
            raise ValueError("a zero leading diagonal needs f >= 2")
        M[:, [0, 1]] = M[:, [1, 0]]  # the dominant entry of column 0 now sits in row 1
        M[:, 0, 0] = 0.0  # a small off-diagonal entry before the swap
    elif kind == "ties":
        if f < 3:
            raise ValueError("ties need f >= 3")
        M[:, :3, :3] = TIE_BLOCK
        M[1::2, 0, 0] = 0.5
        # The block's columns stay on its scale in the other rows (and below
        # the tie in column 0).
        M[:, 3:, :3] = np.clip(M[:, 3:, :3], -2.0, 2.0)
    elif kind == "nan":
        rows = np.arange(b) % 3 == 1
        M[rows, f // 2, (f - 1) // 2] = np.nan
    else:
        raise ValueError(f"unknown kind {kind!r}; choose from {KINDS}")
    return M.astype(dtype)


def nan_rows(M) -> np.ndarray:
    """(b,) bool: the instances whose matrix holds a NaN."""
    return np.isnan(np.asarray(M)).any(axis=(1, 2))


def newton_inputs(seed, b, f, dtype, kind="chord", active="mixed"):
    """``(M, rhs, k, fk, active, scale)`` as numpy arrays."""
    M = chord_matrices(seed, b, f, dtype, kind)
    rng = np.random.default_rng(seed + 1)
    rhs, k, fk = (rng.standard_normal((b, f)).astype(dtype) for _ in range(3))
    mask = {"mixed": rng.uniform(size=b) > 0.4, "all": np.ones(b, bool),
            "none": np.zeros(b, bool)}[active]
    scale = (1e-3 * rng.uniform(0.5, 2.0, (b, f))).astype(dtype)
    return M, rhs, k, fk, mask, scale


def hold(name, got, want, dtype, *, matrix=None, skip_rows=None):
    """Hold the outputs ``got`` to the plain outputs ``want`` (tuples of
    tensors on one device) and return the largest absolute difference.

    - int32 outputs (the permutation) must be equal;
    - with ``matrix``, the first output (the LU) is held to ``tolerance``
      times each instance's max-abs matrix entry;
    - every other floating output to ``tolerance`` relative to the largest
      magnitude of the plain output, per output.

    ``skip_rows`` (b,) bool leaves instances out (the NaN rows, whose
    non-finite results need not match).
    """
    tol = tolerance(dtype)
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if skip_rows is not None:
            keep = ~torch.as_tensor(skip_rows, device=g.device)
            g, w = g[keep], w[keep]
        if not g.is_floating_point():
            if not torch.equal(g, w):
                raise AssertionError(f"{name} output {i}: {int((g != w).sum())} entries differ")
            continue
        if g.numel() == 0:
            continue
        diff = (g.double() - w.double()).abs()
        if i == 0 and matrix is not None:
            m = torch.as_tensor(matrix, device=g.device)
            if skip_rows is not None:
                m = m[keep]
            bound = tol * m.double().abs().amax(dim=(1, 2))[:, None, None]
        else:
            bound = torch.full_like(diff, tol * max(float(w.double().abs().max()), 1e-300))
        bad = ~(diff <= bound)
        if bool(bad.any()):
            raise AssertionError(f"{name} output {i}: {int(bad.sum())} entries beyond the "
                                 f"tolerance, largest difference {float(diff.max())}")
        worst = max(worst, float(diff.max()))
    return worst


def lu_reconstructs(lu, perm, A, dtype):
    """Largest |A[perm] - L @ U| over the instances, relative to each
    instance's max-abs entry of A; raises above ``tolerance`` times f."""
    b, f, _ = lu.shape
    L = torch.tril(lu, -1) + torch.eye(f, dtype=lu.dtype, device=lu.device)
    U = torch.triu(lu)
    PA = torch.gather(A, 1, perm.long()[:, :, None].expand(b, f, f))
    rel = ((PA - L @ U).abs().amax(dim=(1, 2)) / A.abs().amax(dim=(1, 2))).max()
    if not float(rel) <= tolerance(dtype) * f:
        raise AssertionError(f"A[perm] != L @ U: relative difference {float(rel)}")
    return float(rel)


def wide_inputs(seed, b, f, dtype, device):
    """``(M, rhs, k, fk, active, scale)`` as tensors on ``device``: the
    "chord" kind of ``chord_matrices`` (rows shuffled, distinct pivots, the
    same construction) and the vectors of ``newton_inputs``, drawn by a
    ``torch.Generator`` on the device."""
    g = torch.Generator(device=device).manual_seed(seed)

    def unif(*shape):
        return torch.rand(shape, generator=g, dtype=torch.float64, device=device)

    hg = 10.0 ** (2.0 * unif(b, 1) - 2.0)
    D = 1.0 + hg * 10.0 ** (3.0 * unif(b, f))
    M = torch.randn((b, f, f), generator=g, dtype=torch.float64, device=device)
    M.mul_(-0.3 / np.sqrt(f)).diagonal(dim1=1, dim2=2).fill_(1.0)  # I - G, G's diagonal 0
    M.mul_(D[:, :, None])
    M = torch.take_along_dim(M, torch.argsort(unif(b, f), dim=1)[:, :, None], dim=1)
    dt = torch.float32 if dtype in (np.float32, torch.float32) else torch.float64
    rhs, k, fk = (torch.randn((b, f), generator=g, dtype=dt, device=device) for _ in range(3))
    active = unif(b) > 0.4
    scale = (1e-3 * (0.5 + 1.5 * unif(b, f))).to(dt)
    return M.to(dt), rhs, k, fk, active, scale
