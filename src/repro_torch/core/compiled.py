"""Compiled solving: the cached front end and batch sharding across devices.

The JAX package's ``CompiledSolver`` jits the whole solve once per (static
config, shapes) point and later calls dispatch the cached executable; its
loop is one XLA program that never waits on the host.  The port's
counterpart caches, per point, a solve whose loop is captured as CUDA graphs
of ``k`` steps (``core/graphs.py``): ``init`` and ``finish`` run eagerly, the
loop replays its graphs and reads one termination flag per block.

``CompiledSolver``
    Wraps a driver.  ``solve(...)`` looks up an LRU cache keyed on the
    driver's static config (``static_key``: every field but the tolerances),
    the vector field's identity, the shape/dtype/device of every dynamic
    argument, the tolerances' shape class, the device and the cotangent's
    class.  On a miss it builds the entry, and an entry's first solve
    captures its graphs; later same-shaped solves replay them -- no new
    capture.  ``compile(...)``/``prewarm(...)`` build and capture ahead of
    the first request from ``Spec`` (or meta-tensor) stand-ins.

``sharded_solve``
    The batch split across a sequence of devices (the port's stand-in for a
    mesh): each shard runs the whole adaptive loop through a cached entry of
    its own, on its own stream; the results are gathered on the first device.

An entry in flight.  A captured entry's buffers hold one solve at a time:
from ``_CacheEntry.begin`` until its run is closed the entry is ``busy``, a
second ``begin`` on it raises, and the cache never evicts it (an over-full
cache drops idle entries only, and shrinks back at a later lookup).  The
serving layer (``core/serving.py``) keeps several batches in flight this
way, each on an entry of its own.

What is static (a change builds a new entry) and what is dynamic (free to
vary per call) is ``core/static.py``'s contract.  Tolerances are dynamic: a
captured entry reads them from device buffers.

Entries that are not captured.  ``BacksolveAdjoint``, ``events=``, the
implicit steppers, gradient entries (``cotangent=``) and forward-mode
entries (a ``y0``, ``args`` or ``t_eval`` that carries a tangent:
``torch.autograd.forward_ad`` or ``torch.func.jvp``) run the driver's eager
loop through the cache: their loops read the device every step or every
Newton iteration, or autograd records them, or a graph's static buffers
would drop the tangent.  ``CompiledSolve.captured``
is False for them and ``CompiledSolve.why`` says which read holds them.
Whether an entry is captured follows from its static config alone; a capture
that fails raises and never runs the eager loop in its place.  On the CPU a
captured entry runs the same blocks of ``k`` steps without a graph.

Donation.  ``donate="auto"`` donates ``y0`` exactly when ``t_eval is None``
(the final-state regime, where ``ys`` is shaped like ``y0``).  A donated
solve writes the final state into the caller's ``y0`` tensor and returns
that tensor as ``ys``; without donation ``y0`` is untouched.  Only a ``y0``
that is already a tensor on the entry's device (each leaf, for a structured
state) can be donated; any other ``y0`` gets a fresh ``ys``.  Gradient
entries donate nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import OrderedDict
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch
import torch.utils._pytree as pytree

from .drivers import (
    AutoDiffAdjoint,
    BacksolveAdjoint,
    ScanAdjoint,
    _Driver,
    resolve_device,
    to_device,
)
from .graphs import BlockRun, BlockRunner
from .solution import Grads, Solution, map_tensors
from .static import Spec, freeze, frozen_setattr, tree_key
from .stepper import AbstractStepper, DiagonallyImplicitRK
from .terms import ODETerm, _is_number
from ..kernels.ops import carries_tangent

# Steps a captured block runs between two reads of the termination flag.
DEFAULT_K = 16


class CacheInfo(NamedTuple):
    hits: int
    misses: int
    currsize: int
    maxsize: int


def _f_key(f):
    """Cache identity of the dynamics: ODETerms by value, bare callables by
    object identity (cache entries hold ``f``, keeping it alive, so an id can
    never be recycled while its entry exists)."""
    return f if isinstance(f, ODETerm) else (type(f), id(f))


def _vf_name(f) -> str:
    fn = f.f if isinstance(f, ODETerm) else f
    return getattr(fn, "__qualname__", None) or repr(fn)


def _final_state_solution(ys, t_end) -> Solution:
    """The final-state ``Solution`` of a driver that returns only
    ``y(t_end)`` (``BacksolveAdjoint``): status all SUCCESS and no stats, as
    in the JAX package."""
    like = pytree.tree_leaves(ys)[0]
    b = like.shape[0]
    ts = torch.as_tensor(t_end, dtype=like.dtype, device=like.device).expand(b).clone()
    return Solution(ts=ts, ys=ys, status=torch.zeros((b,), dtype=torch.int32,
                                                     device=like.device), stats={})


def _canonical(device) -> torch.device:
    """The device a program runs on, with the card's index made explicit
    (tensors report ``cuda:0``, not ``cuda``)."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _tol_shape(x) -> tuple:
    if isinstance(x, (int, float)):
        return ()
    return tuple(x.shape) if hasattr(x, "shape") else tuple(np.shape(x))


def _uncaptured(driver, grad: bool, forward: bool = False) -> str | None:
    """Why an entry of this static config runs the eager loop, or None when
    its loop is captured."""
    if grad:
        return "gradient entry: autograd records the loop, which a graph does not replay"
    if forward:
        return ("forward mode: a tangent rides on an input (a forward_ad dual or a "
                "torch.func wrapper), which a graph's static buffers would drop")
    if isinstance(driver, BacksolveAdjoint):
        return ("BacksolveAdjoint: its forward and adjoint solves run their own loops "
                "(core/adjoint.py)")
    if driver.events:
        return "events: newly.any() read per step (core/events.py)"
    if isinstance(driver.stepper, DiagonallyImplicitRK):
        return ("implicit stepper: refresh.any() read per step, active.any() per Newton "
                "iteration (core/stepper.py, core/newton.py)")
    return None


def _refuse_grad(y0, args) -> None:
    if not torch.is_grad_enabled():
        return
    if any(isinstance(x, torch.Tensor) and x.requires_grad
           for x in pytree.tree_leaves((y0, args))):
        raise TypeError(
            "a y0 or args tensor requires grad, but a forward entry runs under no_grad "
            "and would drop the gradient: pass cotangent=... for a gradient entry "
            "(ScanAdjoint or BacksolveAdjoint), or detach the inputs")


def _grad_leaf(x, like: torch.Tensor):
    """A differentiable copy of an args leaf: a floating tensor detached and
    made to require grad, a Python float a 0-dim tensor in the state's dtype;
    anything else passes through (and gets no gradient)."""
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.detach().requires_grad_(True)
    if isinstance(x, float):
        return torch.tensor(x, dtype=like.dtype, device=like.device, requires_grad=True)
    return x


class _Config(NamedTuple):
    """What a cache entry needs of its ``CompiledSolver``: the driver, ``k``
    and the key's static part.  Entries hold this, not the solver, so that
    no entry refers back to the cache holding it: a dropped solver frees its
    entries (and their graphs) at once, never later inside a capture."""

    driver: Any
    k: int
    driver_key: tuple
    tol_shapes: tuple

    def driver_for(self, rtol, atol):
        """The driver with the call's tolerance overrides."""
        if rtol is None and atol is None:
            return self.driver
        return dataclasses.replace(self.driver, **{
            name: v for name, v in (("rtol", rtol), ("atol", atol)) if v is not None})

    def tol_key(self, x, i):
        """Shape class of a tolerance override: None when absent or when it
        has the driver tolerance's shape (the same buffers), its shape
        otherwise."""
        if x is None:
            return None
        shape = _tol_shape(x)
        return None if shape == self.tol_shapes[i] else shape

    def key(self, f, y0, t_eval, t_start, t_end, dt0, args, rtol=None, atol=None,
            cotangent=None, *, device) -> tuple:
        # Forward mode is a class of its own: its entry runs the eager loop.
        forward = ("forward mode",) if carries_tangent(
            (y0, t_eval, t_start, t_end, dt0, args, rtol, atol)) else ()
        return forward + (
            self.driver_key,
            _f_key(f),
            tree_key(y0),
            tree_key(t_eval),
            tree_key(t_start),
            tree_key(t_end),
            tree_key(dt0),
            tree_key(args),
            self.tol_key(rtol, 0),
            self.tol_key(atol, 1),
            device,
            tree_key(cotangent),
        )


class _KeyedLRU:
    """The one keyed-LRU implementation behind both front-end caches
    (``CompiledSolver`` and ``sharded_solve``).  An entry that is ``busy``
    (a solve in flight on its buffers) is never evicted: past ``maxsize``
    the least recently used idle entries go, and the cache stays over its
    size until enough entries are idle again."""

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self.data: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key):
        entry = self.data.get(key)
        if entry is not None:
            self.hits += 1
            self.data.move_to_end(key)
        else:
            self.misses += 1
        self._trim(key)
        return entry

    def put(self, key, entry) -> None:
        self.data[key] = entry
        self._trim(key)

    def _trim(self, keep) -> None:
        """Release least recently used idle entries (never ``keep``, the one
        being looked up) until the cache is back to ``maxsize``."""
        excess = len(self.data) - self.maxsize
        if excess <= 0:
            return
        idle = [k for k, e in self.data.items() if k != keep and not e.busy]
        for k in idle[:excess]:
            self.data.pop(k).release()

    def __len__(self) -> int:
        return len(self.data)

    def clear(self) -> None:
        """Release every idle entry; a busy one stays until it is idle."""
        for k in [k for k, e in self.data.items() if not e.busy]:
            self.data.pop(k).release()


class _CacheEntry:
    """One (static config, shapes, device) point of the solve cache: its
    ``BlockRunner`` (built and captured on the entry's first solve, or by
    ``compile``) or, for an uncaptured entry, the reason it runs eagerly."""

    def __init__(self, config: _Config, f, key: tuple, device: torch.device,
                 grad: bool, donate: bool):
        self.config = config
        self.f = f
        self.key = key
        self.device = device
        self.grad = grad
        forward = key[0] == "forward mode"
        self.donate = donate and not grad and not forward
        self.why = _uncaptured(config.driver, grad, forward)
        self.runner: BlockRunner | None = None

    @property
    def built(self) -> bool:
        return self.why is not None or self.runner is not None

    @property
    def busy(self) -> bool:
        """Whether a solve begun on the entry has not been closed: its
        buffers are in use, so the entry is neither evicted nor begun again."""
        return self.runner is not None and self.runner.active is not None

    def release(self) -> None:
        """Free the runner's graphs and buffers (the cache drops the entry).
        A ``CompiledSolve`` still holding the entry builds and captures anew
        on its next call."""
        if self.runner is not None:
            self.runner.release()
            self.runner = None

    def _run_driver(self, drv, y0, t_eval, t_start, t_end, dt0, args) -> Solution:
        if isinstance(drv, BacksolveAdjoint):
            ys = drv.solve(self.f, y0, t_start=t_start, t_end=t_end, args=args,
                           device=self.device)
            return _final_state_solution(ys, t_end)
        return drv.solve(self.f, y0, t_eval, t_start=t_start, t_end=t_end, dt0=dt0,
                         args=args, device=self.device)

    def _start(self, drv, y0, t_eval, t_start, t_end, dt0, args) -> tuple[BlockRun, Any]:
        """Init eagerly, load the runner's buffers (building and capturing
        it on the first call) and return the run and the state's ravel."""
        step_fn, y0_flat, raveled = drv._prepare(self.f, y0, self.device)
        state, consts = step_fn.init(y0_flat, t_eval, t_start, t_end, dt0, args)
        if self.runner is None:
            self.runner = BlockRunner(
                step_fn, state, consts, args, drv.rtol, drv.atol, k=self.config.k,
                max_steps=drv.max_steps, bounded=isinstance(drv, ScanAdjoint))
        run = self.runner.start(state, consts, args, drv.rtol, drv.atol, _vf_name(self.f))
        return run, raveled

    def build(self, y0, t_eval, t_start, t_end, dt0, args, rtol, atol) -> None:
        """Build (and on the card capture) the runner from example inputs."""
        if self.built:
            return
        with torch.no_grad():
            run, _ = self._start(self.config.driver_for(rtol, atol), y0, t_eval, t_start,
                                 t_end, dt0, args)
        run.close()

    def begin(self, y0_in, y0, t_eval, t_start, t_end, dt0, args, rtol, atol, cotangent):
        """Start one solve.  Returns ``(run, finish)``: ``run`` is the
        ``BlockRun`` still to advance (None when the solve already ran:
        uncaptured and gradient entries run the driver's loop here) and
        ``finish()`` returns the ``Solution``.  A captured entry stays busy
        until the caller closes ``run`` -- after ``finish``, once the
        solve's device work is done or ordered before any later use of the
        buffers.  Raises while the entry is busy."""
        drv = self.config.driver_for(rtol, atol)
        if self.grad:
            sol = self._grad(drv, y0, t_eval, t_start, t_end, dt0, args, cotangent)
            return None, lambda: sol
        _refuse_grad(y0, args)
        with torch.no_grad():
            if self.why is not None:
                sol = self._run_driver(drv, y0, t_eval, t_start, t_end, dt0, args)
                return None, lambda: self._donated(sol, y0_in, y0)
            run, raveled = self._start(drv, y0, t_eval, t_start, t_end, dt0, args)

        def finish() -> Solution:
            runner = self.runner
            with torch.no_grad():
                sol = runner.step_fn.finish(runner.state, runner.consts)
                # The solution must not alias the buffers the next solve loads.
                sol = _Driver._finalize(map_tensors(torch.clone, sol), raveled)
                return self._donated(sol, y0_in, y0)

        return run, finish

    def call(self, y0_in, y0, t_eval, t_start, t_end, dt0, args, rtol, atol,
             cotangent) -> Solution:
        return _complete(*self.begin(y0_in, y0, t_eval, t_start, t_end, dt0, args, rtol,
                                     atol, cotangent))

    def _donated(self, sol: Solution, y0_in, y0) -> Solution:
        """Write the final state into the caller's ``y0`` tensor(s) and
        return them as ``ys``, where donation is on and possible."""
        if not self.donate:
            return sol
        given, moved = pytree.tree_leaves(y0_in), pytree.tree_leaves(y0)
        out = pytree.tree_leaves(sol.ys)
        if len(given) != len(out) or not all(
                isinstance(g, torch.Tensor) and g is m and g.shape == o.shape
                and g.dtype == o.dtype for g, m, o in zip(given, moved, out)):
            return sol
        for g, o in zip(given, out):
            g.copy_(o)
        return dataclasses.replace(sol, ys=y0_in)

    def _grad(self, drv, y0, t_eval, t_start, t_end, dt0, args, cotangent) -> Solution:
        """The gradient entry: the driver's solve under autograd, its ``ys``
        pulled back along ``cotangent`` to ``(y0, args)``."""
        with torch.enable_grad():
            y_leaves, y_spec = pytree.tree_flatten(y0)
            y_req = [x.detach().clone().requires_grad_(True) for x in y_leaves]
            like = y_req[0]
            if args is None:
                a_req, a_spec = [], None
            else:
                a_leaves, a_spec = pytree.tree_flatten(args)
                a_req = [_grad_leaf(x, like) for x in a_leaves]
            wrt = [a for a in a_req if isinstance(a, torch.Tensor) and a.requires_grad]
            sol = self._run_driver(drv, pytree.tree_unflatten(y_req, y_spec), t_eval,
                                   t_start, t_end, dt0,
                                   None if args is None else pytree.tree_unflatten(a_req,
                                                                                   a_spec))
            outs = pytree.tree_leaves(sol.ys)
            grads = torch.autograd.grad(outs, y_req + wrt, pytree.tree_leaves(cotangent),
                                        allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, y_req + wrt)]
        g_y0 = pytree.tree_unflatten(grads[:len(y_req)], y_spec)
        g_args = None
        if args is not None:
            it = iter(grads[len(y_req):])
            g_args = pytree.tree_unflatten(
                [next(it) if isinstance(a, torch.Tensor) and a.requires_grad else None
                 for a in a_req], a_spec)
        sol = map_tensors(torch.Tensor.detach, sol)
        return dataclasses.replace(sol, grads=Grads(y0=g_y0, args=g_args))


def _complete(run, finish) -> Solution:
    """Run a begun solve to its end, waiting on each block's flag, and
    return its solution; the run is closed at once, as the next solve on
    its entry is queued after this one's work."""
    if run is None:
        return finish()
    try:
        run.run()
        return finish()
    finally:
        run.close()


class CompiledSolve:
    """The cached solve program of one (static config, shapes, device) point.
    Calling it never builds a new program: arguments whose shapes, dtypes or
    structure differ from the point's raise instead."""

    def __init__(self, entry: _CacheEntry):
        self._entry = entry

    def __call__(self, y0, t_eval=None, *, t_start=None, t_end=None, dt0=None,
                 args: Any = None, rtol=None, atol=None, cotangent=None) -> Solution:
        e = self._entry
        moved = _on_device(e.device, y0, t_eval, t_start, t_end, dt0, args, rtol, atol,
                           cotangent)
        key = e.config.key(e.f, *moved, device=e.device)
        if key != e.key:
            raise ValueError("the arguments' shapes, dtypes or structure differ from the "
                             "point this program was built for")
        return e.call(y0, *moved)

    @property
    def captured(self) -> bool:
        """Whether the loop runs as captured blocks of ``k`` steps (CUDA
        graphs on the card; on the CPU the same blocks without a graph)."""
        return self._entry.why is None

    @property
    def why(self) -> str | None:
        """Why the entry runs the driver's eager loop; None when captured."""
        return self._entry.why

    @property
    def runner(self) -> BlockRunner | None:
        """The entry's ``BlockRunner`` (its buffers, graphs and counters), or
        None before the first solve and for an uncaptured entry."""
        return self._entry.runner

    def as_text(self) -> str:
        """A short description of the program: its graphs, ``k``, the nodes
        of each graph and the device memory the entry holds.  On the card
        the nodes are counted by capturing each block once more
        (``BlockRunner.graph_nodes``)."""
        e = self._entry
        if e.why is not None:
            return f"not captured ({e.why}): the driver's eager loop on {e.device}"
        r = e.runner
        if r is None:
            return f"captured on {e.device}, k = {e.config.k}: not built yet"
        blocks = ", ".join(str(n) for n in r.sizes) or "none"
        if not r.on_card:
            return (f"captured on {e.device}: blocks of {blocks} steps run without a graph "
                    f"(k = {r.k}, max_steps = {r.max_steps}); static buffers "
                    f"{r.buffer_bytes} bytes")
        nodes = ", ".join(f"{n} steps: {c} nodes" for n, c in r.graph_nodes().items())
        return (f"captured on {e.device}: {len(r.graphs)} CUDA graph(s), k = {r.k}, "
                f"max_steps = {r.max_steps} ({nodes}); static buffers {r.buffer_bytes} "
                f"bytes, graph pool {r.pool_bytes()} bytes; "
                f"{'no flag read' if r.bounded else 'one flag read a block'}")


def _on_device(device, y0, t_eval, t_start, t_end, dt0, args, rtol, atol, cotangent):
    """Every array leaf of the dynamic arguments as a tensor on ``device``
    (nested numeric lists for ``y0``/``t_eval`` as one tensor); Python
    numbers stay numbers."""
    def arr(x):
        if isinstance(x, (list, tuple)) and x and all(_is_number(v) for v in
                                                      pytree.tree_leaves(x)):
            return torch.as_tensor(x)
        return x

    return tuple(to_device(x, device) for x in (
        arr(y0), arr(t_eval), t_start, t_end, dt0, args, rtol, atol, cotangent))


def _spec_on(x, device):
    """A dynamic argument as the key sees it on ``device``: every tensor,
    array or ``Spec`` leaf a ``Spec`` there."""
    def leaf(v):
        if isinstance(v, (torch.Tensor, Spec)):
            return Spec(tuple(v.shape), v.dtype, device)
        if isinstance(v, (np.ndarray, np.generic)):
            return Spec(tuple(v.shape), torch.from_numpy(np.empty(0, v.dtype)).dtype, device)
        return v

    if isinstance(x, (list, tuple)) and x and all(_is_number(v) for v in pytree.tree_leaves(x)):
        x = torch.as_tensor(x)
    return pytree.tree_map(leaf, x, is_leaf=lambda v: isinstance(v, Spec))


def _example(x, device, role: str):
    """A concrete stand-in for a spec, to build and capture a program with:
    zeros, a ramp over [0, 1] for ``t_eval``, 1 for ``t_end``, 1e-3 for a
    tolerance.  Concrete tensors and arrays are moved to ``device``."""
    def leaf(v):
        if isinstance(v, Spec) or (isinstance(v, torch.Tensor) and v.is_meta):
            shape = tuple(v.shape)
            if role == "t_eval":
                ramp = torch.linspace(0.0, 1.0, shape[-1], dtype=v.dtype, device=device)
                return ramp.expand(shape).contiguous()
            fill = {"t_end": 1.0, "tol": 1e-3}.get(role, 0.0)
            return torch.full(shape, fill, dtype=v.dtype, device=device)
        return to_device(v, device)

    return pytree.tree_map(leaf, x, is_leaf=lambda v: isinstance(v, Spec))


class CompiledSolver:
    """The cached, captured front end over a loop driver.

    Example (serving loop)::

        solver = CompiledSolver(AutoDiffAdjoint(Stepper("dopri5")))
        for batch in requests:                       # same (b, f) shapes
            sol = solver.solve(f, batch.y0, t_eval)  # captures once, then replays

    ``solve`` arguments and semantics match ``AutoDiffAdjoint.solve``; add
    per-call ``rtol``/``atol`` overrides (dynamic: a new value reuses the
    entry; a new shape class, e.g. a per-instance vector over a scalar
    default, builds one more entry).  The cache key is ``(driver static
    config, f identity, shapes/dtypes/devices of every dynamic argument,
    tolerance shape class, device, cotangent class)``.

    ``k`` (default ``DEFAULT_K``) is the number of steps a captured block
    runs between two host reads of the termination flag -- the one parameter
    the JAX package lacks, whose ``lax.while_loop`` tests termination on the
    device every step.  Steps after every instance has stopped are masked
    no-ops, so ``k`` changes no result, only how many such steps run and how
    often the host waits.

    Captured programs read their inputs from static buffers.  Tensors the
    vector field closes over (rather than receiving through ``args``) are
    read by address: an in-place update such as ``optimizer.step()`` is
    seen by the next replay, rebinding the name to a new tensor is not.  A
    vector field that reads the device (``.item()``, ``bool(tensor)``) makes
    the capture raise, naming the vector field.  Forward entries run under
    ``torch.no_grad()``; a ``y0`` or ``args`` tensor that requires grad
    raises -- gradients go through ``cotangent=``.

    Device memory.  A captured entry holds, while it is cached, a copy of
    the loop state (the dense output, ``b * n * f`` elements, included),
    the loop constants and ``args`` (``BlockRunner.buffer_bytes``) and its
    graphs' memory pool (``BlockRunner.pool_bytes()``, about the step's
    temporaries).  The cache is bounded by ``cache_size`` entries, not by
    bytes: an entry dropped from it (or by ``cache_clear``) frees both.
    """

    __setattr__ = frozen_setattr

    def __init__(
        self,
        solver: _Driver | BacksolveAdjoint | AbstractStepper | str | None = None,
        *,
        donate: bool | str = "auto",
        cache_size: int = 128,
        k: int = DEFAULT_K,
        **driver_kw,
    ):
        if donate not in (True, False, "auto"):
            raise ValueError(f"donate must be True, False or 'auto', got {donate!r}")
        if not isinstance(k, int) or k < 1:
            raise ValueError(f"k must be a positive int, got {k!r}")
        if isinstance(solver, (_Driver, BacksolveAdjoint)):
            if driver_kw:
                raise TypeError("pass driver options to the driver, not CompiledSolver")
            driver = solver
        else:
            driver = AutoDiffAdjoint(AbstractStepper.coerce(solver), **driver_kw)
        self.driver = driver
        self._backsolve = isinstance(driver, BacksolveAdjoint)
        self.donate = donate
        self.cache_size = cache_size
        self.k = k
        self._cache = _KeyedLRU(cache_size)
        self._config = _Config(driver, k, driver.static_key(),
                               (_tol_shape(driver.rtol), _tol_shape(driver.atol)))
        freeze(self)

    def cache_info(self) -> CacheInfo:
        c = self._cache
        return CacheInfo(c.hits, c.misses, len(c), self.cache_size)

    def cache_clear(self) -> None:
        """Drop every entry and free its device memory; an entry with a
        solve in flight stays until it is idle."""
        self._cache.clear()

    def _busy(self, key) -> bool:
        """Whether the entry of ``key`` (``cache_key``) has a solve in
        flight; False when there is no such entry."""
        entry = self._cache.data.get(key)
        return entry is not None and entry.busy

    def _validate(self, t_eval, dt0, cotangent) -> None:
        if self._backsolve and (t_eval is not None or dt0 is not None):
            raise TypeError(
                "BacksolveAdjoint tracks only the final state: pass "
                "t_start/t_end, not t_eval/dt0"
            )
        if cotangent is not None and isinstance(self.driver, AutoDiffAdjoint):
            raise TypeError(
                "AutoDiffAdjoint's while loop has no gradient program: "
                "gradient programs (cotangent=...) need ScanAdjoint "
                "(discretize-then-optimize) or BacksolveAdjoint (adjoint ODE)"
            )

    def cache_key(self, f, y0, t_eval=None, *, t_start=None, t_end=None, dt0=None,
                  args: Any = None, rtol=None, atol=None, device=None,
                  cotangent=None) -> tuple:
        """The hashable identity of the program a ``solve`` with these
        arguments (or ``Spec`` stand-ins) would run: (driver static config,
        dynamics identity, every dynamic argument's shape/dtype class,
        tolerance class, device, cotangent class -- None for forward
        programs).  Two argument sets with equal keys share one entry."""
        self._validate(t_eval, dt0, cotangent)
        device = _canonical(device)
        specs = [_spec_on(x, device) for x in (y0, t_eval, t_start, t_end, dt0, args, rtol,
                                                atol, cotangent)]
        return self._config.key(f, *specs, device=device)

    def _donate(self, t_eval) -> bool:
        if self.donate == "auto":
            return t_eval is None
        return self.donate

    def _lookup(self, f, key, device, t_eval, cotangent) -> _CacheEntry:
        entry = self._cache.get(key)
        if entry is None:
            entry = _CacheEntry(self._config, f, key, device, grad=cotangent is not None,
                                donate=self._donate(t_eval))
            self._cache.put(key, entry)
        return entry

    def compile(self, f, y0, t_eval=None, *, t_start=None, t_end=None, dt0=None,
                args: Any = None, rtol=None, atol=None, device=None,
                cotangent=None) -> CompiledSolve:
        """Build the program for these argument specs (``Spec``, meta tensors
        or example tensors) and return its handle.  A captured entry is
        captured here, from stand-in inputs (zeros, a ramp for ``t_eval``),
        before the first request; a later ``solve`` with matching shapes
        replays it.  ``rtol``/``atol`` specs select the tolerance class,
        ``cotangent`` specs the gradient entry; ``device`` the device (each
        device its own entry)."""
        key = self.cache_key(f, y0, t_eval, t_start=t_start, t_end=t_end, dt0=dt0,
                             args=args, rtol=rtol, atol=atol, device=device,
                             cotangent=cotangent)
        device = _canonical(device)
        entry = self._lookup(f, key, device, t_eval, cotangent)
        if not entry.built:
            tols = [None if x is None else _example(x, device, "tol") for x in (rtol, atol)]
            entry.build(_example(y0, device, "y0"), _example(t_eval, device, "t_eval"),
                        _example(t_start, device, "t_start"),
                        _example(t_end, device, "t_end"), _example(dt0, device, "dt0"),
                        _example(args, device, "args"), *tols)
        return CompiledSolve(entry)

    def prewarm(self, f, specs: "Sequence[dict]") -> int:
        """Build (and capture) a batch of program points before traffic
        arrives.  Each element of ``specs`` is a kwargs mapping for
        :meth:`compile` minus ``f``.  Returns the number of entries built for
        the first time (already-built points are skipped, so prewarming is
        idempotent)."""
        n_new = 0
        for spec in specs:
            spec = dict(spec)
            kw = {k: spec.pop(k, None)
                  for k in ("t_eval", "t_start", "t_end", "dt0", "args",
                            "rtol", "atol", "device", "cotangent")}
            y0 = spec.pop("y0")
            if spec:
                raise TypeError(f"unknown prewarm spec keys: {sorted(spec)}")
            key = self.cache_key(f, y0, **kw)
            entry = self._cache.data.get(key)
            if entry is not None and entry.built:
                continue
            self.compile(f, y0, **kw)
            n_new += 1
        return n_new

    def _begin(self, f, y0, t_eval, t_start, t_end, dt0, args, rtol, atol, device,
               cotangent):
        """Look up (or build) the entry of one solve and start it; returns
        the entry's ``(run, finish)``."""
        self._validate(t_eval, dt0, cotangent)
        device = _canonical(device)
        moved = _on_device(device, y0, t_eval, t_start, t_end, dt0, args, rtol, atol,
                           cotangent)
        key = self._config.key(f, *moved, device=device)
        entry = self._lookup(f, key, device, moved[1], cotangent)
        return entry.begin(y0, *moved)

    def solve(self, f, y0, t_eval=None, *, t_start=None, t_end=None, dt0=None,
              args: Any = None, rtol=None, atol=None, device=None,
              cotangent=None) -> Solution:
        """Solve through the cache.  ``device`` (default: the card) selects
        the entry and receives every dynamic argument.

        ``cotangent`` (shaped like the output ``ys``) runs the gradient entry:
        the returned ``Solution`` also carries ``grads = Grads(y0=dL/dy0,
        args=dL/dargs)``.  It needs ``ScanAdjoint`` or ``BacksolveAdjoint``."""
        return _complete(*self._begin(f, y0, t_eval, t_start, t_end, dt0, args, rtol, atol,
                                      device, cotangent))


# --------------------------------------------------------------------------
# Sharding: the batch axis across devices.

_SHARDED_CACHE = _KeyedLRU(64)


class _Shards:
    """The per-shard solvers of one ``sharded_solve`` point, and the stream
    each card shard runs on.  Never busy: ``sharded_solve`` returns only
    once every shard's run is closed."""

    busy = False

    def __init__(self, driver, devices):
        self.solvers = [CompiledSolver(driver, donate=False) for _ in devices]
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None for d in devices]

    def release(self) -> None:
        for solver in self.solvers:
            solver.cache_clear()


def _record(tree, stream) -> None:
    """Mark every tensor of ``tree`` as in use on ``stream``, so that the
    allocator does not hand its memory out again before ``stream`` is done
    with it."""
    for x in pytree.tree_leaves(tree):
        if isinstance(x, torch.Tensor) and x.is_cuda:
            x.record_stream(stream)


def _concat(sols: list[Solution], device: torch.device) -> Solution:
    """The shards' solutions as one, every tensor gathered on ``device``
    along the batch axis."""
    def cat(*xs):
        if xs[0] is None:
            return None
        return torch.cat([x.to(device) for x in xs], dim=0)

    first = sols[0]
    fields = {}
    for f in dataclasses.fields(first):
        if f.name == "stats":
            fields["stats"] = {k: cat(*(s.stats[k] for s in sols)) for k in first.stats}
        else:
            fields[f.name] = pytree.tree_map(cat, *(getattr(s, f.name) for s in sols))
    return Solution(**fields)


def sharded_solve(
    devices: Sequence,
    f,
    y0,
    t_eval=None,
    *,
    t_start=None,
    t_end=None,
    dt0=None,
    args: Any = None,
    solver: _Driver | None = None,
    method: AbstractStepper | str | None = None,
    rtol=None,
    atol=None,
    **solver_kw,
) -> Solution:
    """Solve a batch of IVPs with the batch split across ``devices``.

    Instances are independent by the solver's core contract, so this is
    embarrassingly parallel: each device runs the complete adaptive loop on
    its ``b / len(devices)`` shard through a cached ``CompiledSolver`` entry
    of its own and stops on its own shard's termination flag.  Shards on the
    card run on streams of their own, each advanced without blocking while
    any of them can move (``BlockRun.advance``); the results are gathered on the first
    device.  ``devices`` may name one device more than once (two shards on
    one card run side by side on two streams).  For explicit steppers
    per-instance results, statuses and stats equal the unsharded solve's,
    but for the whole-batch overhang count ``n_f_evals``: a shard stops
    evaluating the dynamics as soon as its own instances are done.

    Sharding rule: ``y0`` leaves, ``(b,)``-shaped ``t_start``/``t_end``/
    ``dt0``/tolerances, a 2-D ``(b, n)`` ``t_eval`` and any ``args`` leaf
    whose leading dim equals the batch size are split; everything else is
    replicated (a 1-D ``t_eval`` is a shared time grid, whatever its length).
    A batch that does not divide the devices is padded to the next multiple
    with copies of instance 0, solved, and sliced back.

    Pass a configured driver via ``solver=`` or let ``method``/``rtol``/
    ``atol``/``solver_kw`` build an ``AutoDiffAdjoint``.  The per-shard
    solvers are cached (``_SHARDED_CACHE``), so repeated same-shape calls
    replay their captured programs.
    """
    if solver is None:
        solver = AutoDiffAdjoint(
            AbstractStepper.coerce(method),
            rtol=1e-3 if rtol is None else rtol,
            atol=1e-6 if atol is None else atol,
            **solver_kw,
        )
    elif method is not None or rtol is not None or atol is not None or solver_kw:
        raise TypeError(
            "pass solver options (method/rtol/atol/...) to the driver given "
            "via solver=, not to sharded_solve"
        )
    devices = [_canonical(d) for d in devices]
    if not devices:
        raise ValueError("sharded_solve needs at least one device")
    first = devices[0]
    y0, t_eval, t_start, t_end, dt0, args, rtol, atol, _ = _on_device(
        first, y0, t_eval, t_start, t_end, dt0, args, solver.rtol, solver.atol, None)
    y0_leaves = pytree.tree_leaves(y0)
    if not y0_leaves:
        raise ValueError("y0 has no array leaves")
    requested = y0_leaves[0].shape[0]
    n_dev = len(devices)
    n_pad = (-requested) % n_dev
    batch = requested + n_pad
    shared_grid = t_eval is not None and t_eval.ndim == 1

    def batched(x) -> bool:
        return isinstance(x, torch.Tensor) and x.ndim >= 1 and x.shape[0] == requested

    def pad(tree, grid=False):
        # A shared time grid is never a batch axis, even when its length is b.
        if grid or not n_pad:
            return tree
        return pytree.tree_map(
            lambda x: torch.cat([x, x[:1].expand((n_pad,) + x.shape[1:])])
            if batched(x) else x, tree)

    inputs = dict(y0=pad(y0), t_eval=pad(t_eval, shared_grid), t_start=pad(t_start),
                  t_end=pad(t_end), dt0=pad(dt0), args=pad(args), rtol=pad(rtol),
                  atol=pad(atol))
    key = (tuple(devices), solver.static_key(), _f_key(f),
           tuple((name, tree_key(v)) for name, v in inputs.items()))
    shards = _SHARDED_CACHE.get(key)
    if shards is None:
        shards = _Shards(solver, devices)
        _SHARDED_CACHE.put(key, shards)

    m = batch // n_dev

    def part(tree, i, device, grid=False):
        def take(x):
            if isinstance(x, torch.Tensor) and not grid and x.ndim >= 1 and x.shape[0] == batch:
                x = x[i * m:(i + 1) * m]
            return to_device(x, device)

        return pytree.tree_map(take, tree)

    main = torch.cuda.current_stream(first) if first.type == "cuda" else None
    started = []
    try:
        for i, (device, shard_solver, stream) in enumerate(
                zip(devices, shards.solvers, shards.streams)):
            kw = {name: part(v, i, device, grid=name == "t_eval" and shared_grid)
                  for name, v in inputs.items()}
            if stream is None:
                started.append((None, shard_solver._begin(
                    f, kw["y0"], kw["t_eval"], kw["t_start"], kw["t_end"], kw["dt0"], kw["args"],
                    kw["rtol"], kw["atol"], device, None)))
                continue
            if main is not None:
                stream.wait_stream(main)
                _record(kw, stream)
            with torch.cuda.stream(stream):
                started.append((stream, shard_solver._begin(
                    f, kw["y0"], kw["t_eval"], kw["t_start"], kw["t_end"], kw["dt0"], kw["args"],
                    kw["rtol"], kw["atol"], device, None)))
        # Move every shard on as far as it goes, and block on one only when
        # none can move.
        pending = [(stream, run) for stream, (run, _) in started if run is not None]
        while pending:
            moving = []
            for stream, run in pending:
                with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
                    if not run.advance():
                        moving.append((stream, run))
            pending = moving
            if pending and not any(run.ready() for _, run in pending):
                pending[0][1].wait()
        sols = []
        for stream, (_, finish) in started:
            if stream is None:
                sols.append(finish())
                continue
            with torch.cuda.stream(stream):
                sol = finish()
            if main is not None:
                main.wait_stream(stream)
                _record([getattr(sol, f.name) for f in dataclasses.fields(sol)], main)
            sols.append(sol)
    finally:
        for _, (run, _) in started:
            if run is not None:
                run.close()
    sol = _concat(sols, first)
    return sol.slice_batch(slice(0, requested)) if n_pad else sol
