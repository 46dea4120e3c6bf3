"""Bouncing ball: per-instance terminal events + hybrid-system restarts.

    PYTHONPATH=src python -m repro_torch.examples.bouncing_ball [--device cpu]

A batch of balls is dropped from different heights with different
coefficients of restitution.  Each impact is a terminal ``Event`` on the
height: every instance stops independently at ITS localized impact time
(``Status.EVENT``), the solver reports the interpolated impact state, and the
hybrid-system jump (velocity reflection) happens outside the solver before
re-arming the event by solving the next flight segment.  Event times come
from masked bisection on the dense-output interpolant -- zero extra
vector-field evaluations.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import Event, Status, solve_ivp
from . import example_device, parser

G = 9.81
N_BOUNCES = 4


def ball(t, y, args):
    """Free fall: y = (height, velocity)."""
    return torch.stack((y[..., 1], torch.full_like(y[..., 1], -G)), dim=-1)


ground = Event(lambda t, y, args: y[0], terminal=True, direction=-1.0)

h0 = np.array([10.0, 10.0, 4.0, 1.0])
restitution = np.array([0.9, 0.5, 0.7, 0.8])


def segment(y, t, device):
    return solve_ivp(ball, y, None, t_start=t, t_end=t + 10.0, events=ground, rtol=1e-6,
                     atol=1e-9, device=device)


def main(device="cuda", data=None):
    """The reference's script; ``data`` replaces its float32 initial state
    (h0, 0) (the solves take its dtype).  Returns the impact times (b,
    N_BOUNCES) and the impact states (b, N_BOUNCES, 2) as numpy."""
    dev = example_device(device)
    if data is None:
        data = torch.as_tensor(np.stack([h0, np.zeros_like(h0)], 1), dtype=torch.float32)
    y = torch.as_tensor(data).to(dev)
    t = torch.zeros((len(h0),), dtype=y.dtype, device=dev)
    r = torch.as_tensor(restitution, dtype=y.dtype, device=dev)

    print("ball     impact times (s)")
    impacts, states = [], []
    for bounce in range(N_BOUNCES):
        sol = segment(y, t, dev)
        assert bool((sol.status == Status.EVENT.value).all())
        t = sol.ts  # per-instance impact time (== event_t[:, 0])
        impacts.append(t.cpu().numpy())
        states.append(sol.ys.cpu().numpy())
        # hybrid jump: reflect the velocity, damped by the restitution coefficient
        h, v = sol.ys[:, 0], sol.ys[:, 1]
        y = torch.stack([torch.zeros_like(h), -r * v], dim=1)

    impacts = np.stack(impacts, 1)
    for i, row in enumerate(impacts):
        print(f"  #{i}   " + "  ".join(f"{x:7.4f}" for x in row))

    # Analytic check: the first impact is at t = sqrt(2 h0 / g) and every later
    # flight is a scaled replay, so the k-th impact (k = 0, 1, ...) lands at
    # t_k = sqrt(2 h0 / g) * (1 + 2 sum_{j=1..k} r^j).
    t_hit = np.sqrt(2.0 * h0 / G)
    powers = restitution[:, None] ** np.arange(1, N_BOUNCES)[None, :]
    expect = t_hit[:, None] * np.concatenate(
        [np.ones((len(h0), 1)), 1.0 + 2.0 * np.cumsum(powers, axis=1)], axis=1
    )
    err = np.abs(impacts - expect).max()
    print(f"max |impact - analytic| over {N_BOUNCES} bounces: {err:.2e}")
    assert err < 1e-3
    return {"impacts": impacts, "states": np.stack(states, 1), "max_err": float(err)}


if __name__ == "__main__":
    main(parser(__doc__).parse_args().device)
