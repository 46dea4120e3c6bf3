"""The captured solve loop: k steps a block, each block one CUDA graph.

The JAX package's solve is one XLA program: ``lax.while_loop`` around the
step, its termination an on-device reduction, so the host never waits inside
the loop (``src/repro/core/step.py``).  Eagerly, the port's loop dispatches
every operation of every step from the host (over a hundred a step on the
explicit path) and reads ``running.any()`` once a step to decide whether to
go on.

``BlockRunner`` is the port's counterpart for one compiled entry
(``core/compiled.py``).  ``init`` runs eagerly, the loop runs in blocks, and
``finish`` runs eagerly on the result:

- **Static buffers.**  The loop state (``LoopState``), the loop constants
  (``t_eval``, ``t_start``, ``t_end``, direction), the tensor leaves of
  ``args`` and the tolerances live in buffers the runner owns.  Each solve
  copies its inputs into them; a block steps from them and ends by writing
  its state back into them.
- **Graphs.**  On the card one block of ``k`` steps is captured as a CUDA
  graph, and a block of the remainder ``max_steps % k`` as another (they
  share one memory pool).  Before capture one step runs on the capture's
  side stream, so that kernel builds, module loads, cuBLAS workspaces and
  shared-memory opt-ins happen outside the graph.  Capture is capture and
  instantiation only; ``graph_nodes`` and ``pool_bytes`` measure a runner
  when asked.
- **Memory.**  A runner holds, for as long as it lives, its static buffers
  (``buffer_bytes``: a copy of the loop state -- the dense output ``ys`` of
  ``b * n * f`` elements included -- the loop constants, ``args`` and the
  tolerances) and its graphs' pool (``pool_bytes``).  ``release`` frees
  both; the compiled cache calls it when it drops an entry.
- **Termination.**  For ``AutoDiffAdjoint`` the last node of a graph copies
  ``running.any()`` into a pinned host flag.  The host replays a block,
  waits on an event and reads the flag: one host read per block of ``k``
  steps, not one per step.  Steps that run after every instance has stopped
  change nothing the solution holds (the step's ``inc`` guard: the commit,
  the dense output and every statistic are masked by ``running``), so
  ``n_steps``, the statistics, ``ys`` and ``status`` equal the eager loop's.
  The host never runs more than ``max_steps`` steps in all.
- **``ScanAdjoint``** runs exactly ``max_steps`` steps: its blocks are
  replayed back to back and nothing is read.
- **One solve at a time.**  ``start`` loads a solve into the buffers and
  returns its ``BlockRun``; until that run is closed the runner refuses to
  start another (a second load would overwrite a solve in flight), and the
  compiled cache neither evicts nor reloads its entry.  ``BlockRun.advance``
  moves a run on without blocking: it reads the flag only once the last
  block's event has completed (``ready``, an ``event.query()``), which is
  how the serving layer keeps several batches in flight on one host thread.
- **On the CPU** the same blocks run the step function ``k`` times without a
  graph, and the flag is read from the state.

Tolerances are dynamic: the loop's ``StepFunction`` reads them from the
runner's device buffers (a scalar as a 0-dim tensor in the state's dtype),
so a new value runs the same graphs.  The kernels load a tolerance from
memory in the state's dtype exactly as they convert a by-value one, so a
scalar held in a buffer gives the bits of the eager solve.  Python numbers
in ``args`` become 0-dim buffers too (a float in the state's dtype, an int
as int64, a bool as bool), so their values stay dynamic as well.
"""

from __future__ import annotations

import ctypes
import dataclasses
import gc
from typing import Any

import numpy as np
import torch
import torch.utils._pytree as pytree

from .step import StepFunction


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _empty_like(tree):
    return pytree.tree_map(
        lambda x: torch.empty_like(x) if isinstance(x, torch.Tensor) else x, tree)


def _number_buffer(x, like: torch.Tensor) -> torch.Tensor:
    if isinstance(x, bool):
        dtype = torch.bool
    elif isinstance(x, int):
        dtype = torch.int64
    else:
        dtype = like.dtype
    return torch.empty((), dtype=dtype, device=like.device)


def _arg_buffers(args, like: torch.Tensor):
    """Static buffers for ``args``: a tensor leaf gets a buffer of its own
    shape and dtype, a Python number a 0-dim buffer, None stays None."""

    def buffer(x):
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            return torch.empty_like(x, memory_format=torch.contiguous_format)
        if isinstance(x, (bool, int, float)):
            return _number_buffer(x, like)
        raise TypeError(
            f"an args leaf of type {type(x).__name__} cannot be a dynamic argument of a "
            "captured solve: pass tensors, numpy arrays or Python numbers")

    return pytree.tree_map(buffer, args)


def _tol_buffer(tol, like: torch.Tensor) -> torch.Tensor:
    shape = () if isinstance(tol, (int, float)) else tuple(np.shape(tol))
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def _load(buffer: torch.Tensor, value) -> None:
    if isinstance(value, torch.Tensor):
        buffer.copy_(value)
    elif isinstance(value, (bool, int, float)):
        buffer.fill_(value)
    else:
        buffer.copy_(torch.as_tensor(value))


def _storage(x: torch.Tensor) -> int:
    return x.untyped_storage().data_ptr()


_LIBCUDA = None


def _count_nodes(graph) -> int:
    """The node count of a graph captured with ``keep_graph=True``, by the
    CUDA driver's ``cuGraphGetNodes``."""
    global _LIBCUDA
    if _LIBCUDA is None:
        lib = ctypes.CDLL("libcuda.so.1")
        lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_size_t)]
        lib.cuGraphGetNodes.restype = ctypes.c_int
        _LIBCUDA = lib
    n = ctypes.c_size_t(0)
    rc = _LIBCUDA.cuGraphGetNodes(ctypes.c_void_p(int(graph.raw_cuda_graph())), None,
                                  ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {rc}")
    return int(n.value)


class BlockRunner:
    """The static buffers and captured blocks of one compiled entry.

    ``step_fn`` is the ``StepFunction`` of the first solve (its term,
    stepper, controller and layout); ``state``/``consts``/``args`` that
    solve's initial state, loop constants and arguments on the device, and
    ``rtol``/``atol`` its tolerances.  They fix the buffers' shapes; their
    values are loaded by ``start``.  ``bounded`` runs exactly ``max_steps``
    steps (``ScanAdjoint``); otherwise the loop stops once no instance runs
    (``AutoDiffAdjoint``).

    Counters: ``captures`` (graphs captured), ``replays`` (blocks run),
    ``reads`` (host reads of the termination flag).  ``active`` is the run
    whose solve the buffers hold until it is closed, or None.
    """

    def __init__(self, step_fn: StepFunction, state, consts, args, rtol, atol, *, k: int,
                 max_steps: int, bounded: bool):
        like = state.y
        self.device = like.device
        self.on_card = self.device.type == "cuda"
        self.k = k
        self.max_steps = max_steps
        self.bounded = bounded
        self.rtol = _tol_buffer(rtol, like)
        self.atol = _tol_buffer(atol, like)
        self.step_fn = dataclasses.replace(step_fn, rtol=self.rtol, atol=self.atol)
        self.state = _empty_like(state)
        self._state_spec = pytree.tree_structure(self.state)
        self.consts = _empty_like(consts)
        self.args = _arg_buffers(args, like)
        self._static = {_storage(x) for x in _tensors(
            (self.state, self.consts, self.args, self.rtol, self.atol))}
        full, rem = divmod(max_steps, k)
        self.sizes = ([k] if full else []) + ([rem] if rem else [])
        self.graphs: dict[int, Any] = {}
        self.pool = None
        self.captures = self.replays = self.reads = 0
        self.active: BlockRun | None = None
        if self.on_card:
            self.flag = torch.zeros((), dtype=torch.bool, pin_memory=True)
            self.event = torch.cuda.Event()
            self.stream = torch.cuda.Stream(self.device)

    # --- buffers ---
    def load(self, state, consts, args, rtol, atol) -> None:
        """Copy one solve's inputs into the static buffers."""
        if pytree.tree_structure(state) != self._state_spec:
            raise ValueError("the initial state's structure differs from the one the "
                             "entry was built for")
        for dst, src in zip(pytree.tree_leaves(self.state), pytree.tree_leaves(state)):
            dst.copy_(src)
        for dst, src in zip(pytree.tree_leaves(self.consts), pytree.tree_leaves(consts)):
            if dst is not None:
                dst.copy_(src)
        for dst, src in zip(pytree.tree_leaves(self.args), pytree.tree_leaves(args)):
            if dst is not None:
                _load(dst, src)
        _load(self.rtol, rtol)
        _load(self.atol, atol)

    def _write_back(self, new) -> None:
        """Write the block's final state into the static state buffers.  A
        final leaf that lies in a static buffer other than its own is cloned
        first, so that no copy reads a buffer an earlier copy overwrote."""
        if pytree.tree_structure(new) != self._state_spec:
            raise RuntimeError("a step changed the structure of the loop state")
        pairs = []
        for dst, src in zip(pytree.tree_leaves(self.state), pytree.tree_leaves(new)):
            if src is dst:
                continue
            if _storage(src) in self._static:
                src = src.clone()
            pairs.append((dst, src))
        for dst, src in pairs:
            dst.copy_(src)

    def _block(self, n: int) -> None:
        s = self.state
        for _ in range(n):
            s = self.step_fn.step(s, self.consts, self.args)
        self._write_back(s)
        if self.on_card and not self.bounded:
            self.flag.copy_(self.state.running.any(), non_blocking=True)

    # --- capture and replay ---
    def _capture(self, n: int, pool, vf_name: str, keep_graph: bool = False):
        """A graph of one block of ``n`` steps, captured on the runner's side
        stream into ``pool`` (and instantiated unless ``keep_graph``)."""
        graph = torch.cuda.CUDAGraph(keep_graph=keep_graph)
        # A graph destroyed while a stream captures (cudaGraphExecDestroy is
        # refused then) invalidates the capture, and the cyclic collector
        # may run any destructor at any allocation: keep it out of capture.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.no_grad(), torch.cuda.graph(graph, pool=pool, stream=self.stream):
                self._block(n)
        except RuntimeError as err:
            raise RuntimeError(
                f"capturing {n} steps of the solve loop as a CUDA graph failed: a step "
                f"of the vector field {vf_name} (or of a component) reads the device or "
                "copies from the host (.item(), .tolist(), bool(tensor), torch.tensor of "
                "host data), which a graph cannot hold; move that read out of the "
                "vector field") from err
        finally:
            if collecting:
                gc.enable()
        return graph

    def capture(self, vf_name: str) -> None:
        """Warm up one step, then capture a graph of each block size.  Call
        with the buffers loaded; the warm-up step writes into them, so load
        them again before a replay.  Raises if capture fails (it never falls
        back to the eager loop)."""
        if not self.on_card or self.graphs:
            return
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.no_grad(), torch.cuda.stream(self.stream):
            self.step_fn.step(self.state, self.consts, self.args)
        cur.wait_stream(self.stream)
        torch.cuda.synchronize(self.device)
        pool, graphs = torch.cuda.graph_pool_handle(), {}
        for n in self.sizes:
            graphs[n] = self._capture(n, pool, vf_name)
        # Only a capture of every block size installs the graphs.
        self.graphs, self.pool = graphs, pool
        self.captures += len(graphs)

    # --- measurement, on request ---
    @property
    def buffer_bytes(self) -> int:
        """Bytes of the static buffers (state, constants, args, tolerances)."""
        return sum(x.nbytes for x in _tensors(
            (self.state, self.consts, self.args, self.rtol, self.atol)))

    def pool_bytes(self) -> int:
        """Bytes the allocator holds in the graphs' memory pool (0 before
        capture and on the CPU), read from its segment snapshot."""
        if self.pool is None:
            return 0
        pool = tuple(self.pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    def graph_nodes(self) -> dict[int, int]:
        """Nodes in the graph of each block size.  An instantiated graph
        keeps no node list, so each block is captured once more with its
        graph kept, counted and freed; the runner's own graphs and buffers
        are left as they are (a capture runs nothing)."""
        if not self.graphs:
            return {}
        pool, nodes = torch.cuda.graph_pool_handle(), {}
        for n in self.sizes:
            graph = self._capture(n, pool, "(counting nodes)", keep_graph=True)
            nodes[n] = _count_nodes(graph)
            graph.reset()
        return nodes

    def release(self) -> None:
        """Free the graphs, their pool and the static buffers.  The runner
        cannot run again."""
        for graph in self.graphs.values():
            graph.reset()
        self.graphs, self.pool = {}, None
        self.state = self.consts = self.args = self.rtol = self.atol = None
        self.step_fn = None

    def replay(self, n: int) -> None:
        """Run one block of ``n`` steps: replay its graph on the current
        stream (recording the event the flag read waits on), or on the CPU
        run its steps."""
        if self.on_card:
            self.graphs[n].replay()
            if not self.bounded:
                self.event.record()
        else:
            with torch.no_grad():
                self._block(n)
        self.replays += 1

    def ready(self) -> bool:
        """Whether the last replayed block has run, without waiting: on the
        card a query of its event; on the CPU a block runs on the call."""
        return not self.on_card or self.event.query()

    def read(self) -> bool:
        """Whether any instance still runs after the last block: on the card
        the flag its graph wrote, after waiting on the block's event."""
        self.reads += 1
        if self.on_card:
            self.event.synchronize()
            return bool(self.flag)
        return bool(self.state.running.any())

    def start(self, state, consts, args, rtol, atol, vf_name: str) -> "BlockRun":
        """Load one solve's inputs (capturing the graphs on the first) and
        return its run, not yet advanced.  Raises while another run is
        active: its solve still owns the buffers."""
        if self.active is not None:
            raise RuntimeError(
                "this compiled entry's buffers hold a solve still in flight; close its run "
                "before starting another (each batch in flight needs an entry of its own)")
        self.load(state, consts, args, rtol, atol)
        if self.on_card and not self.graphs:
            self.capture(vf_name)
            self.load(state, consts, args, rtol, atol)
        self.active = BlockRun(self, running=self.bounded or state.running.shape[0] > 0)
        return self.active


class BlockRun:
    """One solve in flight through a ``BlockRunner``.  ``advance`` moves it on
    without ever blocking, so one host thread keeps several runs in flight on
    streams of their own (``sharded_solve``, ``SolveService``); ``wait``
    blocks until the block it launched last has run; ``run`` takes it to its
    end.  ``close`` hands the runner's buffers back once the caller is done
    with the solve's device work."""

    def __init__(self, runner: BlockRunner, running: bool):
        self.runner = runner
        self.running = running
        self.it = 0
        self.launched = False  # a block replayed whose flag is not read yet

    def _launch(self) -> bool:
        r = self.runner
        if not self.running or self.it >= r.max_steps:
            return False
        n = min(r.k, r.max_steps - self.it)
        r.replay(n)
        self.it += n
        self.launched = True
        return True

    def _read(self) -> None:
        self.launched = False
        if not self.runner.bounded:
            self.running = self.runner.read()

    def ready(self) -> bool:
        """Whether ``advance`` would find the last block run (without
        waiting): nothing is pending, the run reads no flag, or the block's
        event has completed."""
        return not self.launched or self.runner.bounded or self.runner.ready()

    def advance(self) -> bool:
        """Without blocking: once the last block has run, read its flag and
        launch the next one (a bounded run launches all its blocks, as it
        reads nothing).  Returns True when no block is left to launch."""
        if self.runner.bounded:
            while self._launch():
                pass
            return True
        if self.launched:
            if not self.runner.ready():
                return False
            self._read()
        return not self._launch()

    def wait(self) -> None:
        """Block until the block launched last has run, and read its flag
        (nothing when no block is pending)."""
        if self.launched:
            self._read()

    def run(self) -> None:
        while not self.advance():
            self.wait()

    def close(self) -> None:
        """End the solve: the runner may load another.  Call it once the
        solve's device work is done or ordered before any later use of the
        buffers (on the stream that runs them)."""
        if self.runner.active is self:
            self.runner.active = None
