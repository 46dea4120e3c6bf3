"""Adjoint-equation (optimize-then-discretize) gradients.

torchode's Table 5 finding, as two modes:

  - ``per_instance``: every batch element solves its OWN adjoint ODE with its
    own step size -- state size b*(2f + p).  Faithful to "no within-batch
    interaction", but the parameter adjoint is replicated per instance.
  - ``joint``: the whole batch is ONE solver instance of size 2bf + p -- the
    paper's fast ``torchode-joint`` backward.

``make_adjoint_solve`` and ``make_adjoint_solve_dense`` return solves whose
gradient is a ``torch.autograd.Function``: the forward is a ``solve_ivp``
under no grad and the backward another ``solve_ivp`` of the augmented ODE,
backwards in time, whose dynamics take the vector-product of the user's
vector field by ``torch.func.vjp`` (``torch.func.vmap`` of a one-instance
VJP in ``per_instance`` mode).  So no kernel is differentiated: on the card
both solves run through the kernels as any solve does.  Every solve takes
``device=`` (``None``: the card).
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.utils._pytree as pytree

from .drivers import resolve_device, to_device
from .loop import solve_ivp
from .stepper import AbstractStepper


def _ravel(tree, like):
    """``(flat, unravel)`` of a tree of tensors, as ``ravel_pytree``: the
    tensor leaves flattened and concatenated in ``like``'s dtype on its
    device (an empty vector for a tree without any); ``unravel`` splits a
    vector back into their shapes and dtypes, other leaves (``None``) kept."""
    leaves, spec = pytree.tree_flatten(tree)
    at = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]
    shapes = [tuple(leaves[i].shape) for i in at]
    dtypes = [leaves[i].dtype for i in at]
    flat = (torch.cat([leaves[i].reshape(-1).to(like) for i in at]) if at
            else like.new_zeros((0,)))

    def unravel(v):
        out = list(leaves)
        parts = torch.split(v, [math.prod(s) for s in shapes]) if at else ()
        for i, p, s, d in zip(at, parts, shapes, dtypes):
            out[i] = p.reshape(s).to(d)
        return pytree.tree_unflatten(out, spec)

    return flat, unravel


def _ravel_rows(tree, like):
    """``(rows, unravel_row)`` of a tree whose leaves carry the batch as their
    leading axis: (b, p) rows, and the inverse of one row (leaves without
    the batch axis)."""
    leaves, spec = pytree.tree_flatten(tree)
    b = leaves[0].shape[0]
    rows = torch.cat([x.reshape(b, -1).to(like) for x in leaves], dim=1)
    _, unravel_row = _ravel(pytree.tree_unflatten([x[0] for x in leaves], spec), like)
    return rows, unravel_row


def _joint_dynamics(f, b, feat, flat_params, unravel):
    """The augmented dynamics of the joint backward problem: one instance
    ``[y, a, a_p]`` of size 2bf + p."""
    def aug_dyn(t, s, _):
        y = s[0, : b * feat].reshape(b, feat)
        a = s[0, b * feat : 2 * b * feat].reshape(b, feat)
        tb = t[0].expand(b)
        fv, vjp_fn = torch.func.vjp(lambda y_, fp: f(tb, y_, unravel(fp)), y, flat_params)
        dy_bar, dp_bar = vjp_fn(a)
        return torch.cat([fv.reshape(-1), -dy_bar.reshape(-1), -dp_bar])[None, :]

    return aug_dyn


def _per_instance_dynamics(f, feat, params_of):
    """The augmented dynamics of the per-instance backward problem: b
    instances ``[y_i, a_i, a_p,i]``.  ``params_of`` is ``(flat, unravel)``
    shared by the batch, or ``(rows, unravel_row)`` with one parameter row
    per instance (``batched_args``)."""
    flat, unravel = params_of
    per_row = flat.ndim == 2

    def aug_dyn(t, s, _):
        y = s[:, :feat]
        a = s[:, feat : 2 * feat]

        def single(ti, yi, ai, fpi):
            def fi(ti_, yi_, fp):
                p = unravel(fp)
                if per_row:
                    p = pytree.tree_map(lambda x: x[None], p)
                return f(ti_[None], yi_[None], p)[0]

            fv, vjp_fn = torch.func.vjp(fi, ti, yi, fpi)
            _, dy_bar, dp_bar = vjp_fn(ai)
            return fv, dy_bar, dp_bar

        in_dims = (0, 0, 0, 0 if per_row else None)
        fv, dy_bar, dp_bar = torch.func.vmap(single, in_dims=in_dims)(t, y, a, flat)
        return torch.cat([fv, -dy_bar, -dp_bar], dim=-1)

    return aug_dyn


def _strictest(tol):
    """A (b,)- or (b, f)-shaped tolerance collapsed to its strictest entry
    (a single joint instance cannot honour per-row tolerances)."""
    return torch.as_tensor(tol).min() if getattr(tol, "ndim", 0) else tol


def _leaf_tensors(params, like):
    """``params`` with every numeric leaf a tensor on ``like``'s device."""
    return pytree.tree_map(
        lambda x: x if x is None or isinstance(x, torch.Tensor)
        else torch.as_tensor(x, dtype=like.dtype, device=like.device), params)


def make_adjoint_solve(
    f: Callable,
    *,
    method: str | AbstractStepper = "dopri5",
    rtol=1e-3,
    atol=1e-6,
    max_steps: int = 10_000,
    mode: str = "joint",
    controller=None,
    batched_args: bool = False,
    device=None,
):
    """Returns ``solve(y0, t_start, t_end, params, *, device=None) -> y(t_end)``
    whose gradient solves the adjoint ODE backwards in time (O(1) memory in
    solver steps).

    ``f(t, y, params)`` is the batched dynamics; ``params`` any tree of
    tensors.  ``method`` is a tableau name or a stepper (explicit or
    implicit); the backward solve reuses it.  ``mode`` is "joint" (one
    augmented instance, the paper's recommended default) or "per_instance".

    ``batched_args=True`` declares that every ``params`` leaf carries the
    batch as its leading axis and instance ``i`` owns row ``i``: in
    ``per_instance`` mode each instance's augmented state then carries the
    adjoint of its own row, and the gradient keeps one row per instance.
    Joint mode needs no flag: the whole stack ravels into the augmented
    state.  ``device`` (overridden by the solve's own): ``None`` is the card.
    """
    assert mode in ("joint", "per_instance")

    def forward_solve(y0, t_start, t_end, params, dev):
        return solve_ivp(f, y0, None, t_start=t_start, t_end=t_end, method=method, rtol=rtol,
                         atol=atol, max_steps=max_steps, controller=controller, args=params,
                         device=dev).ys

    class _Solve(torch.autograd.Function):
        @staticmethod
        def forward(ctx, spec, y0, t_start, t_end, *leaves):
            params = pytree.tree_unflatten(list(leaves), spec)
            y1 = forward_solve(y0, t_start, t_end, params, y0.device)
            ctx.spec = spec
            ctx.save_for_backward(y1, t_start, t_end, *leaves)
            return y1

        @staticmethod
        def backward(ctx, g):
            y1, t_start, t_end, *leaves = ctx.saved_tensors
            params = pytree.tree_unflatten(leaves, ctx.spec)
            b, feat = y1.shape
            kw = dict(method=method, max_steps=max_steps, controller=controller,
                      device=y1.device)
            per_row = mode == "per_instance" and batched_args and any(
                isinstance(x, torch.Tensor) for x in leaves)
            if mode == "per_instance":
                params_of = (_ravel_rows if per_row else _ravel)(params, y1)
                p = params_of[0].shape[-1]
                aug0 = torch.cat([y1, g, y1.new_zeros((b, p))], dim=-1)
                sol = solve_ivp(_per_instance_dynamics(f, feat, params_of), aug0, None,
                                t_start=t_end, t_end=t_start, rtol=rtol, atol=atol, **kw)
                a0 = sol.ys[:, feat : 2 * feat]
                y_at_start = sol.ys[:, :feat]
                if per_row:
                    # One gradient row per instance, no cross-instance sum.
                    dparams = torch.func.vmap(params_of[1])(sol.ys[:, 2 * feat :])
                else:
                    dparams = params_of[1](sol.ys[:, 2 * feat :].sum(dim=0))
            else:  # joint: one solver instance of size 2bf + p
                flat, unravel = _ravel(params, y1)
                aug0 = torch.cat([y1.reshape(-1), g.reshape(-1),
                                  y1.new_zeros(flat.shape)])[None, :]
                # One stacked instance: per-row tolerances collapse to the
                # strictest row (the forward solve keeps its rows), and the
                # integration range is the batch-shared one.
                sol = solve_ivp(_joint_dynamics(f, b, feat, flat, unravel),
                                aug0, None, t_start=t_end[:1], t_end=t_start[:1],
                                rtol=_strictest(rtol), atol=_strictest(atol), **kw)
                a0 = sol.ys[0, b * feat : 2 * b * feat].reshape(b, feat)
                y_at_start = sol.ys[0, : b * feat].reshape(b, feat)
                dparams = unravel(sol.ys[0, 2 * b * feat :])
            # Boundary-time gradients: dL/dt_end = g . f(t_end, y1) and
            # dL/dt_start = -a(t_start) . f(t_start, y(t_start)).
            dt_end = torch.sum(g * f(t_end, y1, params), dim=-1)
            dt_start = -torch.sum(a0 * f(t_start, y_at_start, params), dim=-1)
            return None, a0, dt_start, dt_end, *pytree.tree_leaves(dparams)

    def solve(y0, t_start, t_end, params, *, device=None):
        dev = resolve_device(device if device is not None else make_device)
        y0 = torch.as_tensor(to_device(y0, dev), device=dev)
        b = y0.shape[0]
        t_start = torch.as_tensor(t_start, dtype=y0.dtype, device=dev).expand(b)
        t_end = torch.as_tensor(t_end, dtype=y0.dtype, device=dev).expand(b)
        params = _leaf_tensors(to_device(params, dev), y0)
        leaves, spec = pytree.tree_flatten(params)
        return _Solve.apply(spec, y0, t_start, t_end, *leaves)

    make_device = device
    return solve


def adjoint_backsolve_problem(f, y1, g, t_start, t_end, params, *, mode="joint"):
    """The augmented backward IVP itself -- ``(aug_dyn, aug0, t_start',
    t_end')`` -- so benchmarks can measure the backward loop's time and step
    counts with full solver statistics (the quantity in the paper's Table 5).
    The tensors stay on the device they are on."""
    b, feat = y1.shape
    flat, unravel = _ravel(params, y1)
    if mode == "per_instance":
        aug0 = torch.cat([y1, g, y1.new_zeros((b, flat.shape[0]))], dim=-1)
        return _per_instance_dynamics(f, feat, (flat, unravel)), aug0, t_end, t_start
    aug0 = torch.cat([y1.reshape(-1), g.reshape(-1), y1.new_zeros(flat.shape)])[None]
    return (_joint_dynamics(f, b, feat, flat, unravel), aug0,
            torch.as_tensor(t_end)[:1], torch.as_tensor(t_start)[:1])


def make_adjoint_solve_dense(
    f: Callable,
    *,
    method: str = "dopri5",
    rtol=1e-3,
    atol=1e-6,
    max_steps: int = 10_000,
    controller=None,
    device=None,
):
    """Adjoint solve WITH evaluation points: ``solve(y0, t_eval, params, *,
    device=None) -> ys (b, n, f)``, differentiable w.r.t. y0 and params.

    The backward pass integrates the joint augmented ODE SEGMENT-WISE from
    t_n back to t_0 (each segment a full adaptive backsolve), injecting the
    incoming cotangent g[:, i] at each evaluation point -- torchode's
    dense-output adjoint.  t_eval is shared across the batch (joint mode).
    """

    class _Solve(torch.autograd.Function):
        @staticmethod
        def forward(ctx, spec, y0, t_eval, *leaves):
            params = pytree.tree_unflatten(list(leaves), spec)
            ys = solve_ivp(f, y0, t_eval, method=method, rtol=rtol, atol=atol,
                           max_steps=max_steps, controller=controller, args=params,
                           device=y0.device).ys
            ctx.spec = spec
            ctx.save_for_backward(ys, t_eval, *leaves)
            return ys

        @staticmethod
        def backward(ctx, g):
            ys, t_eval, *leaves = ctx.saved_tensors
            params = pytree.tree_unflatten(leaves, ctx.spec)
            b, n, feat = ys.shape
            flat, unravel = _ravel(params, ys)
            aug_dyn = _joint_dynamics(f, b, feat, flat, unravel)
            te = t_eval[0] if t_eval.ndim == 2 else t_eval  # joint: shared grid
            a = ys.new_zeros((b, feat))
            ap = ys.new_zeros(flat.shape)
            for i in range(n - 2, -1, -1):  # integrate te[i + 1] -> te[i]
                a = a + g[:, i + 1]  # the cotangent at the segment's right end
                aug0 = torch.cat([ys[:, i + 1].reshape(-1), a.reshape(-1), ap])[None, :]
                sol = solve_ivp(aug_dyn, aug0, None, t_start=te[i + 1][None],
                                t_end=te[i][None], method=method, rtol=rtol, atol=atol,
                                max_steps=max_steps, controller=controller,
                                device=ys.device)
                a = sol.ys[0, b * feat : 2 * b * feat].reshape(b, feat)
                ap = sol.ys[0, 2 * b * feat :]
            a = a + g[:, 0]  # the cotangent of the initial point (ys[:, 0] == y0)
            return None, a, torch.zeros_like(t_eval), *pytree.tree_leaves(unravel(ap))

    def solve(y0, t_eval, params, *, device=None):
        dev = resolve_device(device if device is not None else make_device)
        y0 = torch.as_tensor(to_device(y0, dev), device=dev)
        t_eval = torch.as_tensor(t_eval, dtype=y0.dtype, device=dev)
        params = _leaf_tensors(to_device(params, dev), y0)
        leaves, spec = pytree.tree_flatten(params)
        return _Solve.apply(spec, y0, t_eval, *leaves)

    make_device = device
    return solve
