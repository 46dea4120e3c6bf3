"""Per-instance event handling: detection and localization on dense output.

An ``Event`` observes the solution through a scalar condition function
``cond_fn(t, y, args)`` and *fires* when that condition crosses zero between
two accepted solver states.  Detection is a per-instance sign test on every
accepted step; localization refines the crossing time by masked bisection on
the stepper's dense-output interpolant (the cubic Hermite the solver already
builds for ``t_eval``), so pinning down the event time costs ZERO extra
vector-field evaluations -- each bisection iteration evaluates only the
interpolant polynomial (the ``masked_bisect_refine`` kernel op) and the
condition function on the interpolated state.

Everything is batched with per-instance masks, the same discipline as the
outer loop: each instance in the batch detects, localizes and (for
``terminal`` events) terminates independently, and instances whose events
already fired ride along frozen.  ``StepFunction`` threads an ``EventState``
through the loop and turns a fired terminal event into a per-instance stop
with ``Status.EVENT``, truncating dense output past the event time.

Semantics (matching ``scipy.integrate.solve_ivp`` events):

direction
    ``0`` fires on any zero crossing, ``> 0`` only when the condition goes
    from negative to positive (rising), ``< 0`` only falling.  A condition
    that is zero at both endpoints of a step does not fire (an identically
    zero condition never fires).
terminal
    ``True`` stops the instance at the event time: its committed state
    becomes the interpolated ``(event_t, event_y)`` and its status
    ``Status.EVENT``.  ``False`` records the FIRST crossing per (instance,
    event) and keeps integrating (fixed-shape buffers cannot hold an
    unbounded crossing list; re-arm by solving again from the event time).

A crossing that enters and leaves zero within a single accepted step (an even
number of crossings) is invisible to the endpoint sign test -- the standard
limitation of sampled event detection; tighten tolerances to shrink steps
near an expected event.

Host reads: ``advance`` reads which events fired anywhere in the batch this
step (``newly.any(dim=0)``, E booleans) and bisects only those -- where the
JAX package branches on the device with ``lax.cond``.  That is one host sync
per step on top of the solve loop's own (ROADMAP A-16 removes both).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Sequence

import torch

from ..kernels import ops


@dataclasses.dataclass(frozen=True)
class Event:
    """A scalar zero-crossing condition on the solution.

    An ``Event`` spec is static solver config: frozen and hashable (the
    condition callable hashes by identity).  Data the condition needs at
    runtime flows through ``args``.

    ``batched=False`` (default): ``cond_fn(t, y, args) -> scalar`` is written
    for a single instance (scalar ``t``, ``(f,)`` -- or the user's structured
    -- state) and is vmapped over the batch (``torch.func.vmap``), mirroring
    scipy's event signature.  ``batched=True``: ``cond_fn`` handles ``(b,)``
    times and ``(b, f)`` states directly and returns ``(b,)`` values (not
    supported for structured states, whose per-instance structure only exists
    inside the vmap).
    """

    cond_fn: Callable[..., Any]
    terminal: bool = True
    direction: float = 0.0
    batched: bool = False
    with_args: bool = True

    def value(self, t: torch.Tensor, y: torch.Tensor, args: Any) -> torch.Tensor:
        """Batched condition values: ((b,), (b, f)) -> (b,)."""
        if self.batched:
            out = self.cond_fn(t, y, args) if self.with_args else self.cond_fn(t, y)
        else:
            if self.with_args:
                out = torch.func.vmap(lambda ti, yi: self.cond_fn(ti, yi, args))(t, y)
            else:
                out = torch.func.vmap(self.cond_fn)(t, y)
        # Contiguous, as the kernels take their inputs (a condition such as
        # ``y[:, 0]`` returns a strided view).
        return torch.as_tensor(out, dtype=y.dtype, device=y.device).reshape(t.shape).contiguous()


def normalize_events(events) -> tuple[Event, ...]:
    """Accept None, a single Event or a sequence; return a tuple of Events."""
    if events is None:
        return ()
    if isinstance(events, Event):
        return (events,)
    events = tuple(events)
    for e in events:
        if not isinstance(e, Event):
            raise TypeError(f"expected Event, got {type(e).__name__}; wrap cond_fn in Event(...)")
    return events


class EventState(NamedTuple):
    """Loop-carried per-instance event bookkeeping (all (b, E)-shaped, E = #events)."""

    value: torch.Tensor  # (b, E) condition values at the current accepted state
    fired: torch.Tensor  # (b, E) bool: first crossing already recorded
    t: torch.Tensor  # (b, E) localized first-crossing times (NaN until fired)
    y: torch.Tensor  # (b, E, f) interpolated states at the crossings


def init_event_state(
    events: Sequence[Event], t0: torch.Tensor, y0: torch.Tensor, args: Any
) -> EventState:
    b, f = y0.shape
    E = len(events)
    value = torch.stack([e.value(t0, y0, args) for e in events], dim=1)
    return EventState(
        value=value,
        fired=torch.zeros((b, E), dtype=torch.bool, device=y0.device),
        t=torch.full((b, E), torch.nan, dtype=t0.dtype, device=t0.device),
        y=torch.zeros((b, E, f), dtype=y0.dtype, device=y0.device),
    )


def _localize(
    event: Event,
    coeffs,
    t0: torch.Tensor,  # (b,) step start times
    dt: torch.Tensor,  # (b,) signed step sizes actually taken
    v0: torch.Tensor,  # (b,) condition values at x = 0
    active: torch.Tensor,  # (b,) bool: instances whose crossing to localize
    args: Any,
    iters: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Bisect the crossing of ``event`` on the interpolant, masked by ``active``.

    The bracket lives in interpolant coordinates x = (t - t0)/dt in [0, 1]
    (monotone along the trajectory for either time direction).  Returns
    ``(x, y)``: the bracket midpoint after ``iters`` halvings and the
    interpolated state there; garbage where ``~active`` (callers mask).
    """
    lo = torch.zeros_like(t0)
    hi = torch.ones_like(t0)
    none = torch.zeros(t0.shape, dtype=torch.bool, device=t0.device)
    # Priming call with an all-False mask: leaves the bracket at [0, 1] and
    # evaluates the interpolant at its midpoint, seeding the loop carry.
    lo, hi, v_lo, mid, y_mid = ops.masked_bisect_refine(coeffs, lo, hi, v0, v0, none)
    for _ in range(iters):
        v_mid = event.value(t0 + mid * dt, y_mid, args)
        lo, hi, v_lo, mid, y_mid = ops.masked_bisect_refine(coeffs, lo, hi, v_lo, v_mid, active)
    return mid, y_mid


class EventAdvance(NamedTuple):
    """What one step's event processing hands back to ``StepFunction.step``."""

    estate: EventState
    stop: torch.Tensor  # (b,) bool: a terminal event fired this step
    t_stop: torch.Tensor  # (b,) earliest terminal event time (valid where stop)
    y_stop: torch.Tensor  # (b, f) interpolated state there (valid where stop)
    n_new: torch.Tensor  # (b,) int32: events recorded this step


def advance(
    events: Sequence[Event],
    estate: EventState,
    coeffs,  # dense-output interpolant coefficients of this step
    t0: torch.Tensor,  # (b,) step start times
    dt: torch.Tensor,  # (b,) signed step sizes actually taken
    t_new: torch.Tensor,  # (b,) step end times
    y_new: torch.Tensor,  # (b, f) accepted candidate states
    accept: torch.Tensor,  # (b,) bool (already masked by running)
    args: Any,
    iters: int,
) -> EventAdvance:
    """Detect, localize and record this step's crossings, per instance.

    Only the events that fired in some instance THIS step are bisected: one
    host read of ``newly.any(dim=0)`` (E booleans) decides, where the JAX
    package runs each bisection under a ``lax.cond`` on the device.  Steps
    without crossings pay E condition evaluations, the detect and commit
    launches and that read.  The results do not depend on the choice:
    inactive rows are masked in ``fused_event_commit``.

    On the card ``fused_event_commit`` writes the recorded crossings into
    ``estate.y`` in place and the new state holds the same buffer (see
    ``StepFunction``).

    Gradients: the bisection returns bracket midpoints that are dyadic
    constants in x, so differentiating ``event_t = t0 + x*dt`` carries only
    the firing step's endpoint sensitivities -- NOT the implicit-function
    event derivative -(dg/dtheta)/(dg/dt).  Treat event-time gradients as
    approximate.
    """
    # Condition evaluation is user code and cannot fuse; the sign tests and
    # the value carry are ONE kernel op.
    v_new = torch.stack([e.value(t_new, y_new, args) for e in events], dim=1)
    newly, v_keep = ops.fused_event_detect(
        estate.value, v_new, estate.fired, accept,
        directions=tuple(e.direction for e in events),
    )  # (b, E) each

    # Columns of events that fired nowhere stay zero, as the JAX package's
    # untaken lax.cond branch leaves them.
    b, f = y_new.shape
    x = torch.zeros((b, len(events)), dtype=t0.dtype, device=t0.device)
    y_ev = torch.zeros((b, len(events), f), dtype=y_new.dtype, device=y_new.device)
    for i, fired_here in enumerate(newly.any(dim=0).tolist()):
        if fired_here:
            x[:, i], y_ev[:, i] = _localize(
                events[i], coeffs, t0, dt, estate.value[:, i].contiguous(),
                newly[:, i].contiguous(), args, iters,
            )

    # Terminal resolution (the instance stops at its EARLIEST terminal
    # crossing; crossings localized after that point happened beyond the end
    # of this instance's trajectory and are discarded -- not recorded, so a
    # re-solve from the event time can still observe them), bookkeeping
    # update and stop outputs: ONE kernel op over the localizer's outputs.
    fired, ev_t, ev_y, stop, t_stop, y_stop, n_new = ops.fused_event_commit(
        x, y_ev, newly, y_new, t0, dt, estate.fired, estate.t, estate.y,
        terminal=tuple(e.terminal for e in events),
    )
    return EventAdvance(
        estate=EventState(value=v_keep, fired=fired, t=ev_t, y=ev_y),
        stop=stop,
        t_stop=t_stop,
        y_stop=y_stop,
        n_new=n_new,
    )
