"""ODE terms: the dynamics wrapper the solver integrates.

The solver's hot loop is strictly batched-flat: ``f(t, y, args)`` with ``t``
of shape (batch,) and ``y`` of shape (batch, features).  ``ODETerm`` adapts
common user signatures onto that convention.

Structured states (nested dicts, lists and tuples of tensors) are ravelled at
the *term boundary* with ``torch.utils._pytree``: the loop, the controller and
the kernels only ever see flat ``(b, f)`` buffers, and the user's vector field
only ever sees its own structure.  ``ravel_state`` builds the round trip,
``ravel_term`` adapts the per-instance structured dynamics onto the flat
batched convention.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.func import vmap

from ..kernels import ops


@dataclasses.dataclass(frozen=True)
class ODETerm:
    """Wraps a vector field ``f(t, y, args) -> dy/dt``.

    Frozen and compared by value (callables compare by identity).  Anything
    the dynamics read at run time belongs in ``args``.

    ``batched=True`` (default): f already handles (b,) times and (b, f) states.
    ``batched=False``: f is written for a single instance (scalar t, (f,) y)
    and is mapped over the batch with ``torch.func.vmap``.

    ``batched_args=True`` declares that every ``args`` leaf carries the batch
    as its leading axis and is mapped per instance alongside ``t`` and ``y``.
    Only meaningful for per-instance dynamics (``batched=False`` terms and
    structured-state solves through ``ravel_term``).

    ``f_jac`` optionally supplies the state Jacobian df/dy for the implicit
    steppers, with the same batching convention as ``f``: per instance it
    maps ((), (f,)) -> (f, f); batched it maps ((b,), (b, f)) -> (b, f, f).
    Without it ``vf_jac`` uses forward-mode autodiff of the vector field.
    """

    f: Callable[..., Any]
    batched: bool = True
    with_args: bool = True
    f_jac: Callable[..., Any] | None = None
    batched_args: bool = False

    def vf(self, t: torch.Tensor, y: torch.Tensor, args: Any) -> torch.Tensor:
        if self.batched:
            out = self.f(t, y, args) if self.with_args else self.f(t, y)
        else:
            if self.with_args:
                if self.batched_args and args is not None:
                    out = vmap(lambda ti, yi, ai: self.f(ti, yi, ai))(t, y, args)
                else:
                    out = vmap(lambda ti, yi: self.f(ti, yi, args))(t, y)
            else:
                out = vmap(self.f)(t, y)
        return torch.as_tensor(out, dtype=y.dtype, device=y.device)

    def vf_jac(self, t: torch.Tensor, y: torch.Tensor, args: Any) -> torch.Tensor:
        """Batched state Jacobian df/dy at (t, y): (b, f, f).

        Used by the implicit steppers to build the Newton matrix
        I - dt*gamma*J.  The default is forward-mode autodiff: one batched JVP
        per feature-basis vector, mapped over the basis with
        ``torch.func.vmap``.  Batch instances are independent by the solver's
        convention (f never mixes instances), so a tangent shared across the
        batch recovers every instance's Jacobian column in one pass, and
        per-instance ``args`` flow through untouched.  Supply ``f_jac`` for an
        analytic or structured Jacobian.
        """
        if self.f_jac is not None:
            if self.batched:
                out = self.f_jac(t, y, args) if self.with_args else self.f_jac(t, y)
            else:
                if self.with_args:
                    if self.batched_args and args is not None:
                        out = vmap(lambda ti, yi, ai: self.f_jac(ti, yi, ai))(t, y, args)
                    else:
                        out = vmap(lambda ti, yi: self.f_jac(ti, yi, args))(t, y)
                else:
                    out = vmap(self.f_jac)(t, y)
            return torch.as_tensor(out, dtype=y.dtype, device=y.device)

        def column(e):  # e: (f,) basis vector -> (b, f) = J @ e per instance
            return torch.func.jvp(lambda yy: self.vf(t, yy, args), (y,), (e.expand_as(y),))[1]

        eye = torch.eye(y.shape[1], dtype=y.dtype, device=y.device)
        return vmap(column)(eye).movedim(0, -1)  # (f_in, b, f_out) -> (b, f_out, f_in)


@dataclasses.dataclass(frozen=True)
class PolynomialTerm(ODETerm):
    """An ``ODETerm`` whose vector field is a closed-form elementwise
    polynomial ``dy_i/dt = sum_d poly_coeffs[d] * y_i**d``.

    The coefficients are static config (a tuple of floats, or of length-f
    float tuples for per-feature coefficients), which is what lets the fused
    step inline the stage evaluations: with ``fused=True`` a whole explicit
    step attempt is one ``fused_step_poly`` launch with no vector-field
    launch.  Construct via ``polynomial_term``.
    """

    poly_coeffs: tuple = ()


def polynomial_term(*coeffs) -> PolynomialTerm:
    """Build a ``PolynomialTerm`` for ``dy/dt = sum_d coeffs[d] * y**d``.

    Each positional coefficient is scalar (shared across features) or a
    length-f sequence (per-feature), low -> high degree::

        polynomial_term(0.0, -1.0)        # dy/dt = -y        (exp decay)
        polynomial_term(0.0, 1.0, -1.0)   # dy/dt = y - y**2  (logistic)

    The term solves identically through every path; with ``fused=True`` its
    stage evaluations run inside the fused step kernel.
    """
    if not coeffs:
        raise ValueError("polynomial_term needs at least one coefficient")
    norm = tuple(
        float(c)
        if np.ndim(c) == 0
        else tuple(float(x) for x in np.asarray(c).reshape(-1))
        for c in coeffs
    )

    def f(t, y, args):
        del t, args  # autonomous by construction
        return ops.poly_eval(y, norm)

    return PolynomialTerm(f=f, batched=True, with_args=True, poly_coeffs=norm)


def as_term(
    f: Callable | ODETerm, *, batched: bool = True, with_args: bool | None = None
) -> ODETerm:
    if isinstance(f, ODETerm):
        return f
    if with_args is None:
        with_args = True
    return ODETerm(f, batched=batched, with_args=with_args)


def _ravel_one(tree) -> torch.Tensor:
    """One instance's structure -> flat (f,) vector, leaves in flatten order."""
    leaves = pytree.tree_leaves(tree)
    return torch.cat([torch.as_tensor(x).reshape(-1) for x in leaves])


class RaveledState(NamedTuple):
    """Round trip between a batched structured state and the flat (b, f)
    buffer the solver loop operates on.

    ``unravel_one`` maps a single (f,) vector back to one instance's
    structure (each leaf in its own shape and dtype).
    """

    unravel_one: Callable[[torch.Tensor], Any]
    num_features: int

    def ravel(self, y: Any) -> torch.Tensor:
        """Batched structure (leaves (b, ...)) -> flat (b, f)."""
        leaves = pytree.tree_leaves(y)
        dtype = _common_dtype(leaves)
        return torch.cat([x.reshape(x.shape[0], -1).to(dtype) for x in leaves], dim=1)

    def unravel(self, ys: torch.Tensor) -> Any:
        """(b, f) -> batched structure; (b, n, f) -> structure with (b, n, ...) leaves."""
        if ys.ndim == 3:
            return vmap(vmap(self.unravel_one))(ys)
        return vmap(self.unravel_one)(ys)


def _common_dtype(leaves):
    dtype = leaves[0].dtype
    for x in leaves[1:]:
        dtype = torch.promote_types(dtype, x.dtype)
    return dtype


def _make_unravel(one_leaves, spec):
    shapes = [tuple(x.shape) for x in one_leaves]
    dtypes = [x.dtype for x in one_leaves]
    sizes = [math.prod(s) for s in shapes]

    def unravel_one(flat):
        parts = torch.split(flat, sizes)
        leaves = [p.reshape(s).to(d) for p, s, d in zip(parts, shapes, dtypes)]
        return pytree.tree_unflatten(leaves, spec)

    return unravel_one


def _is_number(leaf) -> bool:
    return isinstance(leaf, (int, float, complex, bool)) or getattr(leaf, "ndim", None) == 0


def ravel_state(y0: Any) -> tuple[torch.Tensor, RaveledState | None]:
    """Normalize a user initial state onto the flat (b, f) convention.

    Returns ``(y0_flat, raveled)``.  ``raveled`` is ``None`` when ``y0`` is
    already a flat (b, f) tensor or array (or nested numeric lists),
    otherwise a ``RaveledState`` describing the round trip.  Every leaf of a
    structured state must carry the batch as its leading axis.
    """
    if isinstance(y0, (torch.Tensor, np.ndarray)):
        return torch.as_tensor(y0), None
    if isinstance(y0, (list, tuple)):
        # Nested *numeric* lists are the flat-array convenience; a list or
        # tuple with tensor leaves is a genuine structure.
        if all(_is_number(leaf) for leaf in pytree.tree_leaves(y0)):
            arr = torch.as_tensor(y0)
            if arr.ndim == 2:
                return arr, None
    y0 = pytree.tree_map(torch.as_tensor, y0)
    leaves, spec = pytree.tree_flatten(y0)
    one_leaves = [x[0] for x in leaves]
    raveled = RaveledState(unravel_one=_make_unravel(one_leaves, spec),
                           num_features=sum(x.numel() for x in one_leaves))
    return raveled.ravel(y0), raveled


def ravel_term(
    f: Callable | ODETerm, raveled: RaveledState, *, with_args: bool = True,
    batched_args: bool = False,
) -> ODETerm:
    """Adapt a *per-instance* structured vector field ``f(t, y_tree, args) ->
    dy_tree`` onto the flat batched convention.

    Ravel/unravel happens only at this boundary.  With ``batched_args``
    (taken from the term when an ``ODETerm`` is passed), every args leaf
    carries a leading batch axis and is mapped per instance.
    """
    if isinstance(f, ODETerm):
        with_args = f.with_args
        batched_args = f.batched_args
        f = f.f

    def ravel_like(dy, yt):
        # The derivative's leaves in the state's order: a dict the vector
        # field builds in another key order ravels by key, as the state did.
        return _ravel_one(pytree.tree_map(lambda _, d: d, yt, dy))

    def flat_f(t, y, args):
        if with_args and batched_args and args is not None:
            def one_with_args(ti, yi, ai):
                yt = raveled.unravel_one(yi)
                return ravel_like(f(ti, yt, ai), yt).to(yi.dtype)

            return vmap(one_with_args)(t, y, args)

        def one(ti, yi):
            yt = raveled.unravel_one(yi)
            dy = f(ti, yt, args) if with_args else f(ti, yt)
            return ravel_like(dy, yt).to(yi.dtype)

        return vmap(one)(t, y)

    return ODETerm(flat_f, batched=True, with_args=True)
