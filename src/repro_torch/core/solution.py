"""Solution container, per-instance status codes and the gradient record."""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, NamedTuple

import torch
import torch.utils._pytree as pytree


class Grads(NamedTuple):
    """Gradients delivered by a reverse-mode solve program.

    y0:   cotangent of the initial state -- same structure as the ``y0`` that
          was solved, every leaf with the batch as its leading axis (``(b, f)``
          for flat states).
    args: cotangent of the dynamics arguments (same structure as ``args``),
          or ``None`` when the solve carried no args.  When the term batches
          its args (``ODETerm.batched_args``), each leaf's leading axis is the
          batch and row ``i`` is instance ``i``'s own parameter gradient.
    """

    y0: Any
    args: Any = None


class Status(enum.IntEnum):
    """Per-instance termination status (SUCCESS == 0, as in torchode)."""

    SUCCESS = 0
    REACHED_MAX_STEPS = 1
    INFINITE = 2
    REACHED_DT_MIN = 3
    EVENT = 4  # a terminal event fired; the instance stopped at event_t


@dataclasses.dataclass
class Solution:
    """Result of a batched IVP solve.

    ts:     (b, n) evaluation times (== the t_eval passed in), or (b,) the
            per-instance reached times when t_eval is None (t_end on SUCCESS,
            the last accepted time otherwise)
    ys:     (b, n, f) solution values, or (b, f) final states when t_eval is None.
            For a structured initial state, ``ys`` has the same structure with
            (b, n, ...) / (b, ...) leaves.
    status: (b,) int32, one of ``Status``
    stats:  the solver's statistics registry: a dict of named per-instance (b,)
            accumulators contributed by each component (stepper: n_f_evals,
            controller: n_accepted, step function: n_steps, n_initialized,
            the implicit stepper also n_newton_iters and n_jac_evals, plus
            any user-registered contributors)

    event_t:    (b, E) localized first-crossing times per event (NaN where
                an event never fired); None unless events were registered
    event_y:    (b, E, f) interpolated states at those crossings (the
                caller's structure with (b, E, ...) leaves for structured
                states)
    event_mask: (b, E) bool -- which (instance, event) crossings were recorded

    grads:      a ``Grads(y0=..., args=...)`` record when the solution came
                out of a gradient entry (``CompiledSolver.solve(...,
                cotangent=...)``, or a served ``GradRequest``); ``None``
                otherwise.
                Differentiate a solve with ``torch.autograd`` through
                ``ScanAdjoint``/``solve_ivp_scan`` or ``BacksolveAdjoint``.
    """

    ts: torch.Tensor
    ys: Any
    status: torch.Tensor
    stats: dict[str, Any]
    event_t: torch.Tensor | None = None
    event_y: Any = None
    event_mask: torch.Tensor | None = None
    grads: Any = None

    def _tensors(self) -> list[torch.Tensor]:
        return [x for f in dataclasses.fields(self)
                for x in pytree.tree_leaves(getattr(self, f.name))
                if isinstance(x, torch.Tensor)]

    @property
    def success(self) -> torch.Tensor:
        """True where integration ended as requested (reached t_end, or was
        stopped by a terminal event)."""
        return (self.status == Status.SUCCESS.value) | (self.status == Status.EVENT.value)

    def slice_batch(self, index) -> "Solution":
        """A subset of instances: every field taken along the batch axis by
        ``index`` (a ``slice``, an index tensor or list -- anything that keeps
        the leading axis).

        Instances never interact (the solver's batch-invariance contract), so
        a slice is what solving those instances alone gives; ``sharded_solve``
        cuts its padding off this way.  Works on structured ``ys``/``event_y``
        (every leaf carries the batch as its leading axis) and slices each
        stats accumulator and the gradients."""
        take = lambda x: None if x is None else x[index]
        maybe = lambda x: pytree.tree_map(take, x)
        return dataclasses.replace(
            self,
            ts=take(self.ts),
            ys=pytree.tree_map(take, self.ys),
            status=take(self.status),
            stats={k: pytree.tree_map(take, v) for k, v in self.stats.items()},
            event_t=maybe(self.event_t),
            event_y=maybe(self.event_y),
            event_mask=maybe(self.event_mask),
            grads=maybe(self.grads),
        )

    def is_ready(self) -> bool:
        """Whether every tensor can be read without waiting on a device.

        JAX's arrays are futures, each with its own readiness; a CUDA tensor
        has none.  What the port can probe without blocking is a stream: a
        CPU tensor is ready, and a CUDA tensor is ready when the current
        stream of its device has run all the work queued on it
        (``Stream.query``).  Work queued on another stream is not seen, so
        a caller that solved on a stream of its own probes an event it
        recorded there instead -- ``SolveService`` records one per batch in
        flight and never relies on this.
        """
        devices = {x.device for x in self._tensors() if x.is_cuda}
        return all(torch.cuda.current_stream(d).query() for d in devices)

    def block_until_ready(self) -> "Solution":
        """Wait until every device holding a tensor of the solution has run
        all its queued work (``torch.cuda.synchronize``); returns self."""
        for d in {x.device for x in self._tensors() if x.is_cuda}:
            torch.cuda.synchronize(d)
        return self

    def to_host(self) -> "Solution":
        """Every tensor on the CPU: one device-to-host copy per field leaf
        (blocking; CPU tensors are returned as they are).  The serving
        layer copies a harvested batch once, so the per-request
        ``slice_batch`` views that follow are views of host tensors."""
        return map_tensors(lambda x: x.cpu(), self)

    def truncate_eval(self, n: int) -> "Solution":
        """Drop the evaluation points past the first ``n``: ``ts`` becomes
        ``(b, n)`` and every ``ys`` leaf ``(b, n, ...)``.

        The serving layer pads each request's ``t_eval`` to a power-of-two
        length class by repeating its last time; the repeated columns --
        re-evaluations of the interpolant, never solver state -- are cut off
        here.  ``stats`` are left as they are and so count the padded grid
        (``n_initialized`` in particular).  A final-state solution raises.
        """
        if self.ts.ndim < 2:
            raise ValueError(
                "truncate_eval needs a dense-output solution (ts of shape "
                f"(b, n)); this one tracks only final states (ts {tuple(self.ts.shape)})"
            )
        ys = pytree.tree_map(lambda x: x[:, :n], self.ys)
        return dataclasses.replace(self, ts=self.ts[:, :n], ys=ys)


def map_tensors(fn, sol: Solution) -> Solution:
    """``fn`` applied to every tensor of ``sol`` (stats, events and grads
    included); other leaves pass through."""
    def each(x):
        return fn(x) if isinstance(x, torch.Tensor) else x

    return dataclasses.replace(sol, **{
        f.name: pytree.tree_map(each, getattr(sol, f.name)) for f in dataclasses.fields(sol)})
