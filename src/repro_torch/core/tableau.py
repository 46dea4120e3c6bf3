"""Butcher tableaus for the explicit and diagonally implicit RK steppers.

Conventions:
  - ``a`` is the full (s, s) lower-triangular stage matrix.  Explicit methods
    have a zero diagonal; SDIRK/ESDIRK methods carry the implicit coefficient
    ``gamma`` on the diagonal of their implicit stages.
  - ``b_sol`` are the solution weights, ``b_err = b_sol - b_hat`` are the weights
    of the embedded error estimate (``None`` for fixed-step methods).
  - ``fsal``: the last stage equals f(t + dt, y1), so an accepted step seeds the
    next step's first stage for free (First Same As Last).  For the stiffly
    accurate implicit tableaus below (b_sol == last row of ``a``, c_s == 1) the
    same property holds: the last stage derivative IS f(t + dt, y1).
  - ``ssal``: the solution is available before the last stage (Solution Same As
    Last) -- dopri5/tsit5's last stage is evaluated *at* the solution, which also
    makes f1 for dense output free.
  - ``implicit``: at least one diagonal entry of ``a`` is nonzero; the tableau
    must be driven by ``DiagonallyImplicitRK`` (stage equations solved by the
    batched masked-Newton layer), never by the explicit stage recursion.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _readonly(arr: np.ndarray | None) -> np.ndarray | None:
    if arr is None:
        return None
    arr = np.array(arr, copy=True)
    arr.setflags(write=False)
    return arr


def _key(arr: np.ndarray | None):
    return None if arr is None else (arr.shape, arr.dtype.str, arr.tobytes())


@dataclasses.dataclass(frozen=True, eq=False)
class ButcherTableau:
    """A tableau is solver config: its coefficients are host-side numpy
    constants that the kernels receive by value at launch, never device
    tensors.  It is hashable by value and its arrays are frozen read-only
    copies."""

    name: str
    order: int  # order of the solution advance
    error_order: int  # order of the embedded (lower-order) estimate + 1 == controller k
    a: np.ndarray  # (s, s)
    b_sol: np.ndarray  # (s,)
    b_err: np.ndarray | None  # (s,)
    c: np.ndarray  # (s,)
    fsal: bool
    ssal: bool
    implicit: bool = False

    def __post_init__(self):
        for f in ("a", "b_sol", "b_err", "c"):
            object.__setattr__(self, f, _readonly(getattr(self, f)))

    def _identity(self) -> tuple:
        return (
            self.name, self.order, self.error_order,
            _key(self.a), _key(self.b_sol), _key(self.b_err), _key(self.c),
            self.fsal, self.ssal, self.implicit,
        )

    def __eq__(self, other):
        if not isinstance(other, ButcherTableau):
            return NotImplemented
        return self._identity() == other._identity()

    def __hash__(self):
        return hash(self._identity())

    @property
    def stages(self) -> int:
        return len(self.c)

    @property
    def stiffly_accurate(self) -> bool:
        """b_sol equals the last row of ``a``: y1 is the last stage value, so
        (with c_s == 1) the last stage derivative is f(t + dt, y1) for free."""
        return bool(np.allclose(self.a[-1], self.b_sol))

    @property
    def diagonal(self) -> float:
        """The shared implicit coefficient gamma of an SDIRK/ESDIRK tableau
        (every implicit stage carries the same diagonal entry, so one
        I - dt*gamma*J matrix serves all stages of a step)."""
        diag = np.diag(self.a)
        nz = diag[diag != 0.0]
        if nz.size == 0:
            return 0.0
        if not np.allclose(nz, nz[0]):
            raise ValueError(
                f"tableau {self.name!r} has non-constant implicit diagonal {diag}"
            )
        return float(nz[0])


def _tri(rows, s):
    a = np.zeros((s, s), dtype=np.float64)
    for i, row in enumerate(rows):
        a[i + 1, : len(row)] = row
    return a


EULER = ButcherTableau(
    name="euler",
    order=1,
    error_order=2,
    a=np.zeros((1, 1)),
    b_sol=np.array([1.0]),
    b_err=None,
    c=np.array([0.0]),
    fsal=False,
    ssal=False,
)

MIDPOINT = ButcherTableau(
    name="midpoint",
    order=2,
    error_order=2,
    a=_tri([[0.5]], 2),
    b_sol=np.array([0.0, 1.0]),
    b_err=None,
    c=np.array([0.0, 0.5]),
    fsal=False,
    ssal=False,
)

# The classic fixed-step RK4.
RK4 = ButcherTableau(
    name="rk4",
    order=4,
    error_order=4,
    a=_tri([[0.5], [0.0, 0.5], [0.0, 0.0, 1.0]], 4),
    b_sol=np.array([1 / 6, 1 / 3, 1 / 3, 1 / 6]),
    b_err=None,
    c=np.array([0.0, 0.5, 0.5, 1.0]),
    fsal=False,
    ssal=False,
)

# Heun-Euler 2(1) embedded pair.
HEUN = ButcherTableau(
    name="heun",
    order=2,
    error_order=2,
    a=_tri([[1.0]], 2),
    b_sol=np.array([0.5, 0.5]),
    b_err=np.array([0.5, 0.5]) - np.array([1.0, 0.0]),
    c=np.array([0.0, 1.0]),
    fsal=False,
    ssal=False,
)

# Bogacki--Shampine 3(2).
BOSH3 = ButcherTableau(
    name="bosh3",
    order=3,
    error_order=3,
    a=_tri([[1 / 2], [0.0, 3 / 4], [2 / 9, 1 / 3, 4 / 9]], 4),
    b_sol=np.array([2 / 9, 1 / 3, 4 / 9, 0.0]),
    b_err=np.array([2 / 9, 1 / 3, 4 / 9, 0.0]) - np.array([7 / 24, 1 / 4, 1 / 3, 1 / 8]),
    c=np.array([0.0, 1 / 2, 3 / 4, 1.0]),
    fsal=True,
    ssal=True,
)

# Dormand--Prince 5(4), the paper's benchmark method ("dopri5").
_DOPRI5_B = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0])
_DOPRI5_BHAT = np.array(
    [5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40]
)
DOPRI5 = ButcherTableau(
    name="dopri5",
    order=5,
    error_order=5,
    a=_tri(
        [
            [1 / 5],
            [3 / 40, 9 / 40],
            [44 / 45, -56 / 15, 32 / 9],
            [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
            [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
            list(_DOPRI5_B[:6]),
        ],
        7,
    ),
    b_sol=_DOPRI5_B,
    b_err=_DOPRI5_B - _DOPRI5_BHAT,
    c=np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0]),
    fsal=True,
    ssal=True,
)

# Tsitouras 5(4) ("tsit5"), torchode's other recommended method.
_TSIT5_B = np.array(
    [
        0.09646076681806523,
        0.01,
        0.4798896504144996,
        1.379008574103742,
        -3.290069515436081,
        2.324710524099774,
        0.0,
    ]
)
_TSIT5_BERR = np.array(
    [
        -0.00178001105222577714,
        -0.0008164344596567469,
        0.007880878010261995,
        -0.1447110071732629,
        0.5823571654525552,
        -0.45808210592918697,
        1 / 66,
    ]
)
TSIT5 = ButcherTableau(
    name="tsit5",
    order=5,
    error_order=5,
    a=_tri(
        [
            [0.161],
            [-0.008480655492356989, 0.335480655492357],
            [2.8971530571054935, -6.359448489975075, 4.3622954328695815],
            [
                5.325864828439257,
                -11.748883564062828,
                7.4955393428898365,
                -0.09249506636175525,
            ],
            [
                5.86145544294642,
                -12.92096931784711,
                8.159367898576159,
                -0.071584973281401,
                -0.028269050394068383,
            ],
            list(_TSIT5_B[:6]),
        ],
        7,
    ),
    b_sol=_TSIT5_B,
    b_err=_TSIT5_BERR,
    c=np.array([0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0]),
    fsal=True,
    ssal=True,
)

# --------------------------------------------------------------------------
# Diagonally implicit (SDIRK/ESDIRK) tableaus for stiff problems.  All four
# are stiffly accurate (b_sol == last row of a, c_s == 1), so the last stage
# derivative doubles as the FSAL cache, and all share a single diagonal
# coefficient gamma, so one I - dt*gamma*J matrix serves every stage.

# Backward Euler: L-stable, order 1, no embedded estimate (fixed-step).
IMPLICIT_EULER = ButcherTableau(
    name="implicit_euler",
    order=1,
    error_order=2,
    a=np.array([[1.0]]),
    b_sol=np.array([1.0]),
    b_err=None,
    c=np.array([1.0]),
    fsal=True,
    ssal=True,
    implicit=True,
)

# TR-BDF2 as an ESDIRK 2(3) pair (Hosea & Shampine 1996): one trapezoidal
# substage + one BDF2 substage, L-stable, with a 3rd-order embedded estimate.
_TRBDF2_G = 2.0 - np.sqrt(2.0)  # gamma: the intermediate abscissa
_TRBDF2_D = _TRBDF2_G / 2.0  # the shared implicit diagonal
_TRBDF2_W = np.sqrt(2.0) / 4.0
TRBDF2 = ButcherTableau(
    name="trbdf2",
    order=2,
    error_order=3,
    a=np.array(
        [
            [0.0, 0.0, 0.0],
            [_TRBDF2_D, _TRBDF2_D, 0.0],
            [_TRBDF2_W, _TRBDF2_W, _TRBDF2_D],
        ]
    ),
    b_sol=np.array([_TRBDF2_W, _TRBDF2_W, _TRBDF2_D]),
    b_err=np.array([_TRBDF2_W, _TRBDF2_W, _TRBDF2_D])
    - np.array([(1.0 - _TRBDF2_W) / 3.0, (3.0 * _TRBDF2_W + 1.0) / 3.0, _TRBDF2_D / 3.0]),
    c=np.array([0.0, _TRBDF2_G, 1.0]),
    fsal=True,
    ssal=True,
    implicit=True,
)

# Kvaerno (2004) ESDIRK 3(2): A-L stable, explicit first stage.
_KV3_G = 0.43586652150845899941601945
_KV3_A31 = (-4.0 * _KV3_G**2 + 6.0 * _KV3_G - 1.0) / (4.0 * _KV3_G)
_KV3_A32 = (-2.0 * _KV3_G + 1.0) / (4.0 * _KV3_G)
_KV3_A41 = (6.0 * _KV3_G - 1.0) / (12.0 * _KV3_G)
_KV3_A42 = -1.0 / ((24.0 * _KV3_G - 12.0) * _KV3_G)
_KV3_A43 = (-6.0 * _KV3_G**2 + 6.0 * _KV3_G - 1.0) / (6.0 * _KV3_G - 3.0)
_KV3_B = np.array([_KV3_A41, _KV3_A42, _KV3_A43, _KV3_G])
KVAERNO3 = ButcherTableau(
    name="kvaerno3",
    order=3,
    error_order=3,
    a=np.array(
        [
            [0.0, 0.0, 0.0, 0.0],
            [_KV3_G, _KV3_G, 0.0, 0.0],
            [_KV3_A31, _KV3_A32, _KV3_G, 0.0],
            [_KV3_A41, _KV3_A42, _KV3_A43, _KV3_G],
        ]
    ),
    b_sol=_KV3_B,
    b_err=_KV3_B - np.array([_KV3_A31, _KV3_A32, _KV3_G, 0.0]),
    c=np.array([0.0, 2.0 * _KV3_G, 1.0, 1.0]),
    fsal=True,
    ssal=True,
    implicit=True,
)

# Kvaerno (2004) ESDIRK 5(4): the workhorse stiff method (diffrax's kvaerno5).
_KV5_G = 0.26
_KV5_A = np.zeros((7, 7))
_KV5_A[1, :2] = [0.26, 0.26]
_KV5_A[2, :3] = [0.13, 0.84033320996790809, 0.26]
_KV5_A[3, :4] = [0.22371961478320505, 0.47675532319799699, -0.06470895363112615, 0.26]
_KV5_A[4, :5] = [
    0.16648564323248321,
    0.10450018841591720,
    0.03631482272098715,
    -0.13090704451073998,
    0.26,
]
_KV5_A[5, :6] = [
    0.13855640231268224,
    0.0,
    -0.04245337201752043,
    0.02446657898003141,
    0.61943039072480676,
    0.26,
]
_KV5_A[6, :7] = [
    0.13659751177640291,
    0.0,
    -0.05496908796538376,
    -0.04118626728321046,
    0.62993304899016403,
    0.06962479448202728,
    0.26,
]
_KV5_B = _KV5_A[6].copy()
_KV5_BHAT = np.append(_KV5_A[5, :5], [0.26, 0.0])
KVAERNO5 = ButcherTableau(
    name="kvaerno5",
    order=5,
    error_order=5,
    a=_KV5_A,
    b_sol=_KV5_B,
    b_err=_KV5_B - _KV5_BHAT,
    c=np.array([0.0, 0.52, 1.230333209967908, 0.895765984350076, 0.436393609858648, 1.0, 1.0]),
    fsal=True,
    ssal=True,
    implicit=True,
)

TABLEAUS = {
    t.name: t
    for t in (
        EULER,
        MIDPOINT,
        RK4,
        HEUN,
        BOSH3,
        DOPRI5,
        TSIT5,
        IMPLICIT_EULER,
        TRBDF2,
        KVAERNO3,
        KVAERNO5,
    )
}


def get_tableau(name: str) -> ButcherTableau:
    try:
        return TABLEAUS[name]
    except KeyError:
        raise ValueError(f"unknown method {name!r}; available: {sorted(TABLEAUS)}") from None
