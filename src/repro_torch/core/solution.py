"""Solution container and per-instance status codes."""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

import torch


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

    ``grads`` keeps the JAX package's field; it stays None until gradients
    are ported.
    """

    ts: torch.Tensor
    ys: Any
    status: torch.Tensor
    stats: dict[str, Any]
    event_t: torch.Tensor | None = None
    event_y: Any = None
    event_mask: torch.Tensor | None = None
    grads: Any = None

    @property
    def success(self) -> torch.Tensor:
        """True where integration ended as requested (reached t_end, or was
        stopped by a terminal event)."""
        return (self.status == Status.SUCCESS.value) | (self.status == Status.EVENT.value)
