"""Shape-bucketed request coalescing: individual ODE solves served as batches.

The port of the JAX package's ``repro.core.serving``.  Solving many
independent IVPs as one batch pays only if something builds the batches; a
serving deployment sees a stream of single-instance requests, each with its
own initial state, time span, tolerances and solver configuration.
``SolveService`` closes that gap:

1.  ``submit(SolveRequest(...))`` normalizes a request and drops it into a
    **bucket** keyed by everything that selects a compiled program: the
    driver's static config (``static_key``), the dynamics' identity, the
    state structure and leaf shapes/dtypes, the padded eval-grid length
    class and the args structure -- ``CompiledSolver.cache_key`` identity by
    construction.
2.  A bucket flushes when it reaches ``max_batch`` requests (flush-on-size)
    or when its oldest request has waited ``max_delay`` seconds
    (flush-on-deadline, checked on every ``submit``/``poll``/``result``; the
    service is single-threaded and deterministic by design: drive ``poll()``
    from your event loop).  The backlog is bounded by ``max_queue``: a
    submit that would exceed it first launches every bucket.
3.  Flushing pads the batch to a **power-of-two batch-size class** (at most
    ``log2(max_batch) + 1`` entries per bucket, all prewarmable) with copies
    of the first request's row, stacks the rows on the host, moves one
    tensor per field to the **next device in round-robin order** and
    *starts* the solve there without waiting for it.
4.  Started batches sit in a bounded **in-flight window** (``max_inflight``;
    a launch past it first blocks on the oldest batch -- backpressure).
    Every ``submit``/``poll``/``done()`` **advances** each batch in flight as
    far as it goes without blocking and **harvests** the finished ones
    (``drain()``/``result()`` block, and keep the other batches moving while
    they wait): one copy to the host per field, then
    per-request views (``Solution.slice_batch``/``truncate_eval``) resolve
    the futures.  ``max_inflight=0`` is the blocking service (launch and
    harvest inline).  Instances do not interact, so a padded row costs only
    the wasted work counted in ``stats()['pad_waste']``.

How a batch runs without blocking.  In the JAX package a solve is one XLA
program: launching it returns at once and ``Solution.is_ready`` probes its
buffers.  In the port a captured ``CompiledSolver`` entry (``core/graphs.py``)
replays a CUDA graph of k steps and reads a termination flag after each
block, and a CUDA tensor has no readiness of its own.  So the service starts
a batch with ``_CacheEntry.begin`` (init, buffer loads, the capture on an
entry's first solve) on a stream of its own, made to wait first for the
work the caller has queued on its device's current stream (an in-place
update of weights the dynamics close over is seen, as in
``CompiledSolver``; ``prewarm`` builds on slot 0's stream for the same
reason).  It then advances the batch block by block:
``BlockRun.advance`` replays the next block only once the last one's event
has completed (``event.query()``), never waiting.  When no block is left,
``finish`` and a pinned, non-blocking copy of the result to the host run on
the same stream, followed by an event; the harvest probes that event.
Entries that are not captured -- events, implicit steppers,
``BacksolveAdjoint`` and every gradient entry -- run the driver's eager loop
inside ``begin``, so their batches resolve at launch (the host waits there).

One entry per batch in flight.  A captured entry's buffers hold one solve at
a time, so two batches in flight with one key need an entry each.  As
``sharded_solve`` gives each shard a solver of its own, the service keeps up
to ``max(1, max_inflight)`` ``CompiledSolver`` slots per driver config; a
batch takes the first slot whose entry for its key is idle (the window
bounds the busy ones, so one is always idle), and runs on that slot's stream
of its device.  The cache never evicts an entry in flight
(``core/compiled.py``).

Padding policy (as in the JAX package):

* batch axis -- padded up to the next power of two with copies of request 0;
  sliced off at unpack.
* eval grid -- each request's ``t_eval`` is padded to its power-of-two
  length class by repeating the final time; the repeated columns are cut off
  by ``truncate_eval``.
* tolerances, ``t0``/``t1``, ``dt0`` -- per-request scalars stacked into
  ``(b,)`` vectors, dynamic arguments of the entry.

What requests may vary within one bucket: ``y0`` values, ``t0``/``t1``,
``rtol``/``atol``, ``args`` values, eval-grid values (up to the length
class).  What splits buckets: the vector field object, the driver's static
config, state structure or leaf shapes/dtypes, eval-grid length class, args
structure, presence of ``dt0``, forward or gradient.

Requests carry *unbatched* states (1-D tensors or arrays, or structures of
unbatched leaves) and the service stacks them, so a flat-state ``f`` sees
``(b,)`` times, ``(b, f)`` states and per-request args stacked along a new
leading axis.  Structured states go through the drivers' per-instance
convention; their per-request ``args`` ride the ravel boundary
(``ODETerm.batched_args``), so requests with different parameter values
share one bucket and one entry.  Request leaves are torch tensors or numpy
arrays (Python numbers become 0-dim arrays); their dtypes are taken as given.

Gradient serving: a request with ``grad=True`` (a ``GradRequest``, or one
carrying a ``cotangent``) goes to a gradient bucket, whose rows -- the
per-request cotangents included -- pack like forward rows into a
``CompiledSolver(..., cotangent=...)`` gradient entry.  Gradient futures
resolve to ``(solution_view, Grads(y0=..., args=...))``.  Gradient requests
track only the final state; the default gradient driver is ``ScanAdjoint``
(``AutoDiffAdjoint`` has no gradient program), overridable per request via
``method=`` or service-wide via ``default_grad_method``.

Futures resolve to ``Solution``s of CPU tensors (the JAX package's to NumPy
arrays).  ``stats()`` has the JAX package's keys: queue depth, batches, pad
waste, solves/sec, gradient solves and their device time, the in-flight
window, cache hits/misses and the async split ``queue_s`` (submit to
launch), ``pack_s`` (host stacking, the move to the device and ``begin``),
``device_s`` (launch to observed completion), plus the summed per-instance
statistics of every solution served under ``solver/<name>``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from collections import OrderedDict, deque
from typing import Any, Callable

import numpy as np
import torch
import torch.utils._pytree as pytree

from .compiled import CompiledSolver, _canonical, _f_key
from .drivers import AutoDiffAdjoint, BacksolveAdjoint, ScanAdjoint, _Driver, to_device
from .solution import Solution, map_tensors
from .static import Spec, tree_key
from .stepper import AbstractStepper
from .terms import ODETerm
from ..kernels.ops import carries_tangent


def next_pow2(n: int) -> int:
    """The smallest power of two >= n (the batch/eval-grid size classes)."""
    if n < 1:
        raise ValueError(f"need a positive size, got {n}")
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class SolveRequest:
    """One IVP to solve: a single instance, not a batch.

    f:        the vector field (callable or ``ODETerm``).  Requests sharing a
              bucket must reuse the *same object* -- identity is program
              identity (as everywhere in the compiled front end).
    y0:       unbatched initial state: a 1-D ``(f,)`` tensor or array, or a
              structure (dict, list, tuple) of unbatched leaves.
    t0, t1:   the integration span (scalars; backward spans allowed).
    t_eval:   optional 1-D evaluation grid (its own length per request --
              grids bucket by power-of-two length class).  ``None`` requests
              only the final state.
    args:     optional per-request dynamics arguments (leaves are stacked
              along a new leading batch axis across the bucket).
    rtol, atol: per-request tolerances; default to the method's.
    method:   stepper name / ``AbstractStepper`` / configured driver; default
              is the service's ``default_method`` (``default_grad_method``
              for gradient requests, which need ``ScanAdjoint`` or
              ``BacksolveAdjoint``).
    dt0:      optional fixed initial step size.
    grad:     request gradients: the future resolves to ``(solution_view,
              Grads(y0=..., args=...))``, the final state's VJP pulled back
              through the solve.  Implied by a non-None ``cotangent``.
              Gradient requests track only the final state.
    cotangent: the output cotangent to pull back -- ``y0``'s structure and
              leaf shapes.  Defaults to ones (the gradient of ``sum(y1)``).
    """

    f: Any
    y0: Any
    t0: float
    t1: float
    t_eval: Any = None
    args: Any = None
    rtol: float | None = None
    atol: float | None = None
    method: Any = None
    dt0: float | None = None
    grad: bool = False
    cotangent: Any = None


@dataclasses.dataclass(frozen=True)
class GradRequest(SolveRequest):
    """A ``SolveRequest`` that asks for gradients (``grad=True`` by default):
    ``GradRequest(f, y0, t0, t1, cotangent=dL_dy1, args=theta)`` resolves to
    ``(solution_view, Grads(y0=dL/dy0, args=dL/dtheta))``."""

    grad: bool = True


class _Item:
    """A normalized, validated request queued in a bucket."""

    __slots__ = ("f", "y0", "t0", "t1", "t_eval", "n_eval", "args",
                 "rtol", "atol", "dt0", "grad", "cotangent", "t_enq")

    def __init__(self, f, y0, t0, t1, t_eval, n_eval, args, rtol, atol, dt0,
                 grad=False, cotangent=None):
        self.f = f
        self.y0 = y0
        self.t0 = t0
        self.t1 = t1
        self.t_eval = t_eval
        self.n_eval = n_eval  # the request's true grid length (pre-padding)
        self.args = args
        self.rtol = rtol
        self.atol = atol
        self.dt0 = dt0
        self.grad = grad
        self.cotangent = cotangent  # validated to mirror y0; None iff not grad
        self.t_enq = 0.0  # service clock at submit, for the queue_s split


def _on(stream):
    """The context that makes ``stream`` current (nothing for the CPU)."""
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def _pinned_copy(x: torch.Tensor) -> torch.Tensor:
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return out.copy_(x, non_blocking=True)


class _Inflight:
    """One started-but-unharvested batch: its run (the captured loop's
    blocks still to launch, or None), its ``finish`` and, once finished,
    its host copy and the event that says when the copy has landed."""

    __slots__ = ("batch", "bucket", "run", "finish", "launch_pc", "device", "stream",
                 "host", "event")

    def __init__(self, batch, bucket, run, finish, launch_pc, device, stream):
        self.batch = batch          # [(item, future), ...] in submit order
        self.bucket = bucket
        self.run = run              # BlockRun, or None when begin ran the solve
        self.finish = finish        # -> the batched Solution on the device
        self.launch_pc = launch_pc  # perf_counter when begin returned
        self.device = device
        self.stream = stream        # the slot's stream on a card, else None
        self.host: Solution | None = None
        self.event = None           # recorded after the host copy, on a card

    def advance(self) -> bool:
        """Take the batch as far as it goes without waiting: the captured
        loop's next block once the last one has run, then, with no block
        left, ``finish`` and the copy to the host, all on the batch's
        stream.  True once the host copy has landed."""
        if self.host is None:
            if self.run is not None and not self.run.ready():
                return False
            with _on(self.stream):
                if self.run is not None and not self.run.advance():
                    return False
                sol = self.finish()
                if self.stream is None:
                    self.host = sol.to_host()
                else:
                    self.host = map_tensors(_pinned_copy, sol)
                    self.event = torch.cuda.Event()
                    self.event.record(self.stream)
        return self.event is None or self.event.query()

    def wait(self) -> None:
        """Block until the work the batch last queued has run: its last
        block (whose flag is read) or its copy to the host."""
        if self.host is None:
            if self.run is not None:
                self.run.wait()
        elif self.event is not None:
            self.event.synchronize()

    def close(self) -> None:
        """Hand the entry back (its device work is done or abandoned)."""
        if self.run is not None:
            self.run.close()


class SolveFuture:
    """Handle to one submitted request.

    A request moves through three states: *queued* (waiting in its bucket),
    *in-flight* (its batch started on a device, not yet harvested) and
    *done*.  ``done()`` is non-blocking: it advances and harvests the
    batches in flight, then reports whether this one resolved.

    ``result()`` returns the request's ``Solution`` view (batch axis kept,
    with exactly one instance: ``ys`` leaves are ``(1, ...)``, stats
    ``(1,)``), its tensors on the CPU: a batch leaves the device in one copy
    per field, and the per-request views are views of it.  If the request is
    in flight, ``result()`` blocks until its batch completes; if it is still
    *queued*, ``result()`` flushes its bucket first (``flush=False`` raises
    instead).

    For a gradient request, ``result()`` returns ``(view, grads)``: the view
    and a ``Grads(y0=..., args=...)`` record with the batch axis stripped
    (``args`` None when the request carried none).
    """

    __slots__ = ("_service", "_bucket", "_inflight", "_solution", "_error",
                 "_grad")

    def __init__(self, service: "SolveService", bucket: "_Bucket",
                 grad: bool = False):
        self._service = service
        self._bucket = bucket
        self._inflight: _Inflight | None = None
        self._solution: Solution | None = None
        self._error: BaseException | None = None
        self._grad = grad

    def done(self) -> bool:
        if self._solution is None and self._error is None:
            self._service._harvest_ready()
        return self._solution is not None or self._error is not None

    def result(self, flush: bool = True):
        if self._solution is None and self._error is None:
            if self._inflight is None:
                if not flush:
                    raise RuntimeError(
                        "request still queued; pass flush=True or call "
                        "SolveService.flush()/poll() first")
                self._service._execute(self._bucket)
            if self._inflight is not None:
                self._service._harvest(self._inflight, block=True)
        if self._error is not None:
            raise self._error
        if self._grad:
            grads = pytree.tree_map(lambda x: None if x is None else x[0],
                                    self._solution.grads)
            return self._solution, grads
        return self._solution


class _Bucket:
    """All queued requests that can share one compiled entry."""

    __slots__ = ("key", "driver", "slots", "f", "time_dtype", "n_eval_class",
                 "has_args", "has_dt0", "grad", "pending", "oldest")

    def __init__(self, key, driver, slots, f, time_dtype, n_eval_class,
                 has_args, has_dt0, grad=False):
        self.key = key
        self.driver = driver
        self.slots = slots  # the driver config's CompiledSolver slots (shared)
        self.f = f
        self.time_dtype = time_dtype
        self.n_eval_class = n_eval_class  # padded grid length, or None
        self.has_args = has_args
        self.has_dt0 = has_dt0
        self.grad = grad  # gradient bucket: packs cotangents, runs the gradient entry
        self.pending: list[tuple[_Item, SolveFuture]] = []
        self.oldest: float | None = None  # enqueue time of the oldest pending


def _stack(*xs):
    return torch.stack(xs)


class SolveService:
    """Request-coalescing front end over ``CompiledSolver``.

    Example (serving loop)::

        svc = SolveService(max_batch=16, max_delay=2e-3, max_inflight=4)
        svc.prewarm(SolveRequest(f, y0_example, 0.0, 1.0))   # optional
        futs = [svc.submit(SolveRequest(f, y0, t0, t1)) for ...]
        svc.poll()     # advance and harvest batches in flight + deadline-flush
        svc.flush()    # start whatever is still queued (non-blocking)
        sols = [f.result() for f in futs]  # blocks per in-flight batch

    Parameters: ``max_batch`` (power of two; flush-on-size threshold and
    padded-batch ceiling), ``max_delay`` (seconds a request may wait before
    its bucket is flushed on the next ``submit``/``poll``; ``None`` disables
    deadline flushing), ``max_queue`` (total backlog bound; exceeding it
    starts every bucket), ``max_inflight`` (started-but-unharvested batch
    window; a launch past it first blocks on the oldest batch, and ``0``
    makes every execution synchronous), ``devices`` (the devices batches
    round-robin over; default every CUDA device -- raises without a card;
    pass ``["cpu"]`` to serve on the CPU, and a device may be named more
    than once), ``default_method``, ``default_grad_method`` (for gradient
    requests without one; default a ``ScanAdjoint`` over the stepper),
    ``donate``/``cache_size`` (forwarded to each ``CompiledSolver``) and
    ``clock`` (injectable monotonic clock, for deterministic deadline
    tests).

    Memory: each slot's entries are LRU-bounded by ``cache_size`` entries
    (an entry in flight is never evicted); a captured entry holds its static
    buffers -- the dense ``ys`` of ``b * n * f`` elements included -- and
    its graph pool while it is cached, and there are up to
    ``max(1, max_inflight)`` slots per driver config.  Bucket and slot
    bookkeeping grows with the number of distinct configurations served.
    """

    def __init__(
        self,
        *,
        max_batch: int = 16,
        max_delay: float | None = 0.01,
        max_queue: int = 4096,
        max_inflight: int = 4,
        devices=None,
        default_method: Any = None,
        default_grad_method: Any = None,
        donate: bool | str = "auto",
        cache_size: int = 128,
        clock: Callable[[], float] = time.monotonic,
    ):
        if max_batch < 1 or (max_batch & (max_batch - 1)) != 0:
            raise ValueError(f"max_batch must be a power of two, got {max_batch}")
        if max_queue < max_batch:
            raise ValueError("max_queue must be at least max_batch")
        if max_inflight < 0:
            raise ValueError(f"max_inflight must be >= 0, got {max_inflight}")
        self.max_batch = max_batch
        self.max_delay = max_delay
        self.max_queue = max_queue
        self.max_inflight = max_inflight
        self.devices = _serving_devices(devices)
        self.default_method = default_method
        self.default_grad_method = default_grad_method
        self.donate = donate
        self.cache_size = cache_size
        self.clock = clock
        self._buckets: OrderedDict[tuple, _Bucket] = OrderedDict()
        # Buckets with pending requests, in first-enqueue order: the deadline
        # sweep runs on every submit, so it scans only the waiting buckets.
        self._waiting: OrderedDict[tuple, _Bucket] = OrderedDict()
        # Per driver config, the CompiledSolver slots (each holds its own
        # entries; a batch takes a slot whose entry for its key is idle).
        self._solvers: dict[Any, list[CompiledSolver]] = {}
        self._streams: dict[tuple, Any] = {}  # (slot, device) -> its stream on a card
        # Per-submit memos; entries keep their driver alive, so an id can
        # never be recycled while its memo exists.
        self._driver_memo: dict[Any, Any] = {}
        self._driver_keys: dict[int, tuple] = {}
        self._queue_depth = 0
        self._inflight: deque[_Inflight] = deque()
        self._rr = 0  # round-robin cursor over self.devices
        self._counters = {
            "n_requests": 0,
            "n_completed": 0,
            "n_batches": 0,
            "n_rows": 0,
            "n_pad_rows": 0,
            "n_deadline_flushes": 0,
            "n_size_flushes": 0,
            "n_failed_batches": 0,
            "n_backpressure_waits": 0,
            "peak_inflight": 0,
            "n_grad_solves": 0,
        }
        self._solver_totals: dict[str, float] = {}
        self._queue_s = 0.0
        self._pack_s = 0.0
        self._device_s = 0.0
        self._grad_device_s = 0.0

    # ------------------------------------------------------------------
    # request normalization and bucketing

    def _coerce_driver(self, method, grad: bool = False):
        if method is None:
            method = self.default_grad_method if grad else self.default_method
        if isinstance(method, (_Driver, BacksolveAdjoint)):
            return method
        memo_key = (grad,
                    method if isinstance(method, (str, type(None))) else id(method))
        hit = self._driver_memo.get(memo_key)
        if hit is None:
            stepper = AbstractStepper.coerce(method)
            # Gradient entries need a driver with a gradient program.
            driver = ScanAdjoint(stepper) if grad else AutoDiffAdjoint(stepper)
            # The memo holds ``method`` too, so its id is never recycled.
            hit = self._driver_memo[memo_key] = (driver, method)
        return hit[0]

    def _driver_key_of(self, driver):
        entry = self._driver_keys.get(id(driver))
        if entry is None:
            entry = (driver, driver.static_key())
            self._driver_keys[id(driver)] = entry
        return entry[1]

    @staticmethod
    def _as_array(x) -> torch.Tensor:
        """A request leaf as a CPU tensor, its dtype as given (numpy's for
        arrays and Python numbers): bucket keys, prewarm specs and the packed
        batch all see the same dtype."""
        if isinstance(x, torch.Tensor):
            return x.detach().cpu()
        return torch.as_tensor(np.asarray(x))

    def _normalize(self, req: SolveRequest) -> tuple[_Item, Any]:
        grad = bool(req.grad) or req.cotangent is not None
        driver = self._coerce_driver(req.method, grad)
        if grad and isinstance(driver, AutoDiffAdjoint):
            raise TypeError(
                "gradient requests need a reverse-differentiable driver "
                "(ScanAdjoint or BacksolveAdjoint); AutoDiffAdjoint's "
                "while loop has no gradient program.  Pass method=ScanAdjoint(...) "
                "or set the service's default_grad_method."
            )
        if grad and req.t_eval is not None:
            raise ValueError(
                "gradient requests track only the final state: the cotangent "
                "pulls back through y(t1), so t_eval must be None"
            )
        if isinstance(driver, BacksolveAdjoint) and (
                req.t_eval is not None or req.dt0 is not None):
            raise TypeError(
                "BacksolveAdjoint serves final-state solves only: requests "
                "routed to it cannot carry t_eval or dt0"
            )
        if grad and isinstance(driver, BacksolveAdjoint) and driver.mode == "joint":
            raise TypeError(
                "coalesced gradient serving needs row-independent backward "
                "solves: BacksolveAdjoint(mode='joint') stacks the whole "
                "batch into one adjoint instance with a batch-shared time "
                "range, which a bucket of independent requests cannot "
                "guarantee.  Use mode='per_instance' (or ScanAdjoint)."
            )
        y0 = pytree.tree_map(self._as_array, req.y0)
        flat = isinstance(y0, torch.Tensor)
        if flat and y0.ndim != 1:
            raise ValueError(
                f"request y0 must be an unbatched 1-D state or a structure of "
                f"leaves, got a bare array of shape {tuple(y0.shape)}; reshape to "
                "1-D or nest it"
            )
        leaves = pytree.tree_leaves(y0)
        if not leaves:
            raise ValueError("request y0 has no array leaves")
        f = req.f
        args = None
        if req.args is not None:
            args = pytree.tree_map(self._as_array, req.args)
            # Per-request args always batch like y0: each leaf is stacked
            # along a new leading axis at pack time.  Per-instance dynamics
            # (structured states through the ravel boundary, or batched=False
            # terms) would see the whole stack shared, so mark the term
            # batched_args: the vmap then hands each instance its own row.
            # ODETerm compares by value, so equal wrappers of one vector
            # field still share a bucket and an entry.
            backsolve_grad = grad and isinstance(driver, BacksolveAdjoint)
            if isinstance(f, ODETerm):
                if not flat or not f.batched or backsolve_grad:
                    f = dataclasses.replace(f, batched_args=True)
            elif not flat:
                f = ODETerm(f, batched=False, with_args=True, batched_args=True)
            elif backsolve_grad:
                # The per-instance backward solve closes the dynamics over
                # one instance's parameters at a time; without the flag it
                # would hand every instance the whole stacked-args batch.
                f = ODETerm(f, batched=True, with_args=True, batched_args=True)
        rtol = req.rtol if req.rtol is not None else driver.rtol
        atol = req.atol if req.atol is not None else driver.atol
        for name, tol in (("rtol", rtol), ("atol", atol)):
            if np.ndim(tol) != 0:
                raise ValueError(
                    f"per-request {name} must be scalar (got shape "
                    f"{np.shape(tol)}); per-feature tolerances do not fit "
                    "the (b,)-vector packing"
                )
        t_eval, n_eval = None, None
        if req.t_eval is not None:
            t_eval = np.asarray(req.t_eval, dtype=np.float64)
            if t_eval.ndim != 1 or t_eval.shape[0] < 1:
                raise ValueError(
                    f"request t_eval must be a non-empty 1-D grid, got shape "
                    f"{t_eval.shape}"
                )
            n_eval = int(t_eval.shape[0])
        cotangent = None
        if grad:
            if req.cotangent is None:
                # Default pullback: sum the gradient over state features.
                cotangent = pytree.tree_map(torch.ones_like, y0)
            else:
                cot = pytree.tree_map(self._as_array, req.cotangent)
                if pytree.tree_structure(cot) != pytree.tree_structure(y0):
                    raise ValueError(
                        "cotangent must mirror y0's structure "
                        f"(got {pytree.tree_structure(cot)}, "
                        f"expected {pytree.tree_structure(y0)})"
                    )
                for cl, yl in zip(pytree.tree_leaves(cot), leaves):
                    if cl.shape != yl.shape:
                        raise ValueError(
                            f"cotangent leaf shape {tuple(cl.shape)} does not "
                            f"match the y0 leaf shape {tuple(yl.shape)}"
                        )
                # The pullback's output is ys (y0's dtype): cast rather than
                # letting another dtype split the bucket.
                cotangent = pytree.tree_map(lambda c, y: c.to(y.dtype), cot, y0)
        item = _Item(f, y0, float(req.t0), float(req.t1), t_eval, n_eval,
                     args, float(rtol), float(atol),
                     None if req.dt0 is None else float(req.dt0),
                     grad, cotangent)
        return item, driver

    def _bucket_for(self, item: _Item, driver) -> _Bucket:
        driver_key = self._driver_key_of(driver)
        n_eval_class = None if item.n_eval is None else next_pow2(item.n_eval)
        key = (
            driver_key,
            _f_key(item.f),
            tree_key(item.y0),
            n_eval_class,
            tree_key(item.args),
            item.dt0 is None,
            # Forward and gradient requests never share a bucket: they run
            # different entries (the driver key already separates adjoint
            # configs).  The cotangent's class is y0's by validation.
            item.grad,
        )
        bucket = self._buckets.get(key)
        if bucket is None:
            slots = self._solvers.setdefault(driver_key, [])
            if not slots:
                slots.append(self._new_solver(driver))
            time_dtype = functools.reduce(torch.promote_types,
                                          [leaf.dtype for leaf in pytree.tree_leaves(item.y0)])
            bucket = _Bucket(key, driver, slots, item.f, time_dtype,
                             n_eval_class, item.args is not None,
                             item.dt0 is not None, item.grad)
            self._buckets[key] = bucket
        return bucket

    def _new_solver(self, driver) -> CompiledSolver:
        return CompiledSolver(driver, donate=self.donate, cache_size=self.cache_size)

    # ------------------------------------------------------------------
    # queueing policies

    def submit(self, req: SolveRequest) -> SolveFuture:
        """Queue one request; returns its future.  May start batches: the
        request's own bucket on flush-on-size, expired buckets on
        flush-on-deadline, everything on backlog overflow.  Starts do not
        wait for the device (unless ``max_inflight`` forces a backpressure
        wait); batches in flight are advanced and harvested on the way in."""
        if carries_tangent((req.y0, req.t0, req.t1, req.t_eval, req.args, req.rtol, req.atol,
                            req.dt0, req.cotangent)):
            raise TypeError(
                "a request tensor carries a forward-mode tangent (a forward_ad dual or a "
                "torch.func wrapper), which the service's packed batch buffers would drop: "
                "solve it with solve_ivp or AutoDiffAdjoint under torch.func.jvp instead")
        self.poll()
        if self._queue_depth >= self.max_queue:
            self.flush()
        item, driver = self._normalize(req)
        bucket = self._bucket_for(item, driver)
        fut = SolveFuture(self, bucket, grad=item.grad)
        item.t_enq = self.clock()
        if not bucket.pending:
            bucket.oldest = item.t_enq
            self._waiting[bucket.key] = bucket
        bucket.pending.append((item, fut))
        self._queue_depth += 1
        self._counters["n_requests"] += 1
        if len(bucket.pending) >= self.max_batch:
            self._counters["n_size_flushes"] += 1
            self._execute(bucket)
        return fut

    def poll(self) -> int:
        """One cooperative tick of the serving engine: advance every batch in
        flight as far as it goes without blocking and harvest the finished
        ones, then start every bucket that is due -- full ones always,
        waiting ones when their oldest request has aged past ``max_delay``.
        Runs the harvest and the size sweep even with ``max_delay=None``.
        Returns the number of batches started."""
        self._harvest_ready()
        if not self._waiting:
            return 0
        now = self.clock() if self.max_delay is not None else None
        n = 0
        for bucket in list(self._waiting.values()):
            if not bucket.pending:
                continue
            if len(bucket.pending) >= self.max_batch:
                self._counters["n_size_flushes"] += 1
                self._execute(bucket)
                n += 1
            elif now is not None and now - bucket.oldest >= self.max_delay:
                self._counters["n_deadline_flushes"] += 1
                self._execute(bucket)
                n += 1
        return n

    def flush(self) -> int:
        """Start every non-empty bucket (non-blocking; harvest with
        ``drain()``/``poll()``/``result()``).  Returns the number of batches
        started."""
        n = 0
        for bucket in list(self._waiting.values()):
            if bucket.pending:
                self._execute(bucket)
                n += 1
        return n

    def drain(self, n: int | None = None) -> int:
        """Blocking harvest of up to ``n`` batches in flight (oldest first;
        all of them when ``n`` is None).  Does not start queued buckets --
        pair with ``flush()`` for a full barrier.  Returns the number of
        batches harvested."""
        harvested = 0
        while self._inflight and (n is None or harvested < n):
            self._harvest(self._inflight[0], block=True)
            harvested += 1
        return harvested

    # ------------------------------------------------------------------
    # packing and execution

    def _pack(self, bucket: _Bucket, items: list[_Item]) -> dict:
        """Stack per-request rows into the bucket's padded batch arguments,
        on the host: one stack per field, moved to the device as one tensor
        (per-row copies to the device would cost more than the solve at
        serving batch sizes)."""
        b = min(next_pow2(len(items)), self.max_batch)
        rows = items + [items[0]] * (b - len(items))
        td = bucket.time_dtype
        vec = lambda vals: torch.tensor(vals, dtype=td)
        kw = dict(
            y0=pytree.tree_map(_stack, *[r.y0 for r in rows]),
            t_eval=None,
            t_start=vec([r.t0 for r in rows]),
            t_end=vec([r.t1 for r in rows]),
            dt0=None,
            args=None,
            rtol=vec([r.rtol for r in rows]),
            atol=vec([r.atol for r in rows]),
            cotangent=None,
        )
        if bucket.n_eval_class is not None:
            n_class = bucket.n_eval_class
            grids = [np.concatenate([r.t_eval, np.full(n_class - r.n_eval, r.t_eval[-1])])
                     for r in rows]
            kw["t_eval"] = torch.as_tensor(np.stack(grids), dtype=td)
        if bucket.has_args:
            kw["args"] = pytree.tree_map(_stack, *[r.args for r in rows])
        if bucket.has_dt0:
            kw["dt0"] = vec([r.dt0 for r in rows])
        if bucket.grad:
            # Pad rows reuse request 0's cotangent; their gradients are
            # sliced off with the rest of the padding.
            kw["cotangent"] = pytree.tree_map(_stack, *[r.cotangent for r in rows])
        return kw

    def _slot(self, bucket: _Bucket, key) -> tuple[int, CompiledSolver]:
        """The first slot whose entry for ``key`` is idle (a new slot when
        none is: at most ``max(1, max_inflight)`` are ever made, since the
        window bounds the batches in flight)."""
        for i, solver in enumerate(bucket.slots):
            if not solver._busy(key):
                return i, solver
        bucket.slots.append(self._new_solver(bucket.driver))
        return len(bucket.slots) - 1, bucket.slots[-1]

    def _stream(self, slot: int, device: torch.device):
        if device.type != "cuda":
            return None
        stream = self._streams.get((slot, device))
        if stream is None:
            stream = self._streams[(slot, device)] = torch.cuda.Stream(device)
        return stream

    def _execute(self, bucket: _Bucket) -> None:
        """Pack and start a bucket's pending batch on the next device in
        round-robin order.  Non-blocking: the batch joins the in-flight
        window and its futures resolve at harvest.  A start that would
        exceed ``max_inflight`` first blocks on the oldest batch in flight
        (backpressure); ``max_inflight=0`` harvests inline."""
        if not bucket.pending:
            return
        batch = bucket.pending
        bucket.pending = []
        bucket.oldest = None
        self._waiting.pop(bucket.key, None)
        self._queue_depth -= len(batch)
        while self._inflight and len(self._inflight) >= max(1, self.max_inflight):
            self._counters["n_backpressure_waits"] += 1
            self._harvest(self._inflight[0], block=True)
        device = self.devices[self._rr % len(self.devices)]
        self._rr += 1
        items = [item for item, _ in batch]
        now = self.clock()
        t0 = time.perf_counter()
        try:
            kw = self._pack(bucket, items)
            key = bucket.slots[0].cache_key(bucket.f, device=device, **kw)
            slot, solver = self._slot(bucket, key)
            stream = self._stream(slot, device)
            if stream is not None:
                # The caller's queued work (a prewarm's loads, an in-place
                # update of weights the dynamics close over) runs first.
                stream.wait_stream(torch.cuda.current_stream(device))
            with _on(stream):
                kw = to_device(kw, device)
                run, finish = solver._begin(
                    bucket.f, kw["y0"], kw["t_eval"], kw["t_start"], kw["t_end"], kw["dt0"],
                    kw["args"], kw["rtol"], kw["atol"], device, kw["cotangent"])
        except Exception as e:  # deliver to the owners, keep the service up
            self._counters["n_failed_batches"] += 1
            for _, fut in batch:
                fut._error = e
            return
        launch_pc = time.perf_counter()
        self._pack_s += launch_pc - t0
        self._queue_s += sum(now - item.t_enq for item in items)
        b = pytree.tree_leaves(kw["y0"])[0].shape[0]
        self._counters["n_batches"] += 1
        self._counters["n_rows"] += b
        self._counters["n_pad_rows"] += b - len(batch)
        rec = _Inflight(batch, bucket, run, finish, launch_pc, device, stream)
        self._inflight.append(rec)
        self._counters["peak_inflight"] = max(self._counters["peak_inflight"],
                                              len(self._inflight))
        for _, fut in batch:
            fut._inflight = rec
        if self.max_inflight == 0:
            self._harvest(rec, block=True)

    def _harvest_ready(self) -> int:
        """Advance every batch in flight as far as it goes without blocking
        and harvest the finished ones.  Returns the number delivered.

        Every record is probed: each runs on a stream of its own, so batches
        on one device need not complete in launch order (the JAX package
        stops at a device's first unready batch)."""
        n = 0
        for rec in list(self._inflight):
            if self._harvest(rec, block=False):
                n += 1
        return n

    def _harvest(self, rec: _Inflight, *, block: bool) -> bool:
        """Deliver one started batch: advance it (to its end when ``block``),
        and once its host copy has landed slice per-request views and
        resolve the futures.  While it waits on this batch, the host keeps
        advancing the other batches in flight, as a device runs every launch
        queued on it."""
        if not any(r is rec for r in self._inflight):
            return True  # already harvested through another entry point
        batch = rec.batch
        try:
            while not rec.advance():
                if not block:
                    return False
                for other in list(self._inflight):
                    if other is not rec:
                        self._harvest(other, block=False)
                rec.wait()
        except Exception as e:  # a failure inside the loop surfaces here
            self._inflight.remove(rec)
            rec.close()
            self._counters["n_failed_batches"] += 1
            for _, fut in batch:
                fut._error = e
                fut._inflight = None
            return True
        self._inflight.remove(rec)
        rec.close()
        sol, bucket = rec.host, rec.bucket
        elapsed = time.perf_counter() - rec.launch_pc
        self._device_s += elapsed
        self._counters["n_completed"] += len(batch)
        if bucket.grad:
            self._grad_device_s += elapsed
            self._counters["n_grad_solves"] += len(batch)
        for name, acc in sol.stats.items():
            self._solver_totals[name] = (
                self._solver_totals.get(name, 0.0) + float(acc[: len(batch)].sum())
            )
        for i, (item, fut) in enumerate(batch):
            view = sol.slice_batch(slice(i, i + 1))
            if item.n_eval is not None and item.n_eval < bucket.n_eval_class:
                view = view.truncate_eval(item.n_eval)
            fut._solution = view
            fut._inflight = None
        return True

    # ------------------------------------------------------------------
    # prewarming and stats

    def prewarm(self, example: SolveRequest, batch_classes=None) -> int:
        """Build (and on a card capture) the entries ``example``-shaped
        requests will hit, one per power-of-two batch-size class (default:
        every class up to ``max_batch``) *per serving device*, in the first
        slot and on its stream.  Returns the number of entries newly built; built classes are
        skipped, so prewarming is idempotent.  Uses
        ``CompiledSolver.prewarm`` with ``Spec`` stand-ins; a later flush of
        a matching bucket that finds the first slot idle hits the cache."""
        item, driver = self._normalize(example)
        bucket = self._bucket_for(item, driver)
        if batch_classes is None:
            batch_classes = [1 << i for i in range(self.max_batch.bit_length())]
        td = bucket.time_dtype

        def rows(b, tree):
            return pytree.tree_map(lambda x: Spec((b,) + tuple(x.shape), x.dtype), tree)

        specs = []
        for b in batch_classes:
            if b < 1 or b > self.max_batch or (b & (b - 1)) != 0:
                raise ValueError(
                    f"batch class {b} is not a power of two within max_batch="
                    f"{self.max_batch}"
                )
            vec = Spec((b,), td)
            spec = dict(y0=rows(b, item.y0), t_start=vec, t_end=vec, rtol=vec, atol=vec)
            if bucket.n_eval_class is not None:
                spec["t_eval"] = Spec((b, bucket.n_eval_class), td)
            if bucket.has_args:
                spec["args"] = rows(b, item.args)
            if bucket.has_dt0:
                spec["dt0"] = vec
            if bucket.grad:
                spec["cotangent"] = rows(b, item.cotangent)
            for device in self.devices:
                specs.append(dict(spec, device=device))
        # Each entry is built on the stream slot 0 runs it on, so its loads
        # are ordered before the first batch's.
        for device in dict.fromkeys(self.devices):
            stream = self._stream(0, device)
            if stream is not None:
                stream.wait_stream(torch.cuda.current_stream(device))
        n = 0
        for spec in specs:
            with _on(self._stream(0, spec["device"])):
                n += bucket.slots[0].prewarm(bucket.f, [spec])
        return n

    def stats(self) -> dict[str, Any]:
        """Snapshot of the serving surface: queue/bucket/in-flight state,
        padding waste, the async time split -- ``queue_s`` (submit to
        launch), ``pack_s`` (host stacking, the move to the device and the
        start), ``device_s`` (launch to observed harvest; overlapped batches
        double-count wall time) -- realized solves/sec (completed requests
        over ``busy_s = pack_s + device_s``), cache counters summed over
        every slot's ``CompiledSolver``, and the aggregated solver
        statistics under ``solver/<name>``."""
        hits = misses = programs = 0
        for slots in self._solvers.values():
            for solver in slots:
                info = solver.cache_info()
                hits += info.hits
                misses += info.misses
                programs += info.currsize
        c = self._counters
        busy_s = self._pack_s + self._device_s
        out: dict[str, Any] = {
            "queue_depth": self._queue_depth,
            "n_buckets": len(self._buckets),
            "n_inflight": len(self._inflight),
            "n_devices": len(self.devices),
            **c,
            "pad_waste": (c["n_pad_rows"] / c["n_rows"]) if c["n_rows"] else 0.0,
            "solves_per_sec": (c["n_completed"] / busy_s) if busy_s > 0 else 0.0,
            "queue_s": self._queue_s,
            "pack_s": self._pack_s,
            "device_s": self._device_s,
            "grad_device_s": self._grad_device_s,
            "busy_s": busy_s,
            "cache_hits": hits,
            "cache_misses": misses,
            "n_programs": programs,
        }
        for name, total in sorted(self._solver_totals.items()):
            out[f"solver/{name}"] = total
        return out


def _serving_devices(devices) -> tuple[torch.device, ...]:
    """The devices to serve on: every CUDA device when ``devices`` is None
    (raising without one: there is no silent fallback to the CPU)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices=['cpu'] to serve on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"cannot serve on {d}: no CUDA device is available")
        out.append(_canonical(d))
    if not out:
        raise ValueError("need at least one device to serve on")
    return tuple(out)
