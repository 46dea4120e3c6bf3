"""The workloads that drive the port's paths on the card.

``vdp_table3``: the paper's Table 3 setup -- 256 Van der Pol oscillators,
mu = 2, one cycle, 200 evaluation points, atol = rtol = 1e-5
(``benchmarks/vdp_bench.py`` in the JAX package), initial states from numpy
seed 0.

``full_width``: a neural ODE at a size its users run on a GPU, chosen as an
explicit assumption: b = 1024 instances of f = 784 features (a flattened
28x28 image, as in continuous normalising flows on MNIST), the vector field
``tanh(y W1 + b1) W2 + b2`` with hidden width 1024, weights from numpy seed 0
at 1/sqrt(fan_in) scale, t in [0, 1] with 64 evaluation points, tol 1e-5.
The products go to ``torch.matmul``.  With these weights the solve takes only
4 steps, so it exercises the kernels at full width but never reaches a
steady state.

``full_width_long``: the same shapes, structure, seed and tolerance, with the
weights at 3x that scale and t in [0, 8], so dopri5 takes some 50-60 steps
with rejections (54 loop iterations, 49 accepted, for rows 0-31 on the CPU)
-- the tens of dopri5 steps per solve, hundreds of evaluations, that
published continuous normalising flows on MNIST spend (FFJORD, Grathwohl et
al. 2019).  Per-step numbers come from this one.

``step_bench``: the JAX package's fused workload (``benchmarks/step_bench.py``:
exponential decay dy/dt = -y by ``polynomial_term``, dopri5 with the PID
controller, rtol 1e-4, atol 1e-6, t in [0, 2], dense output off) at
full_width's shape, y0 = linspace(0.5, 1.5) over the b * f entries: with
``fused=True`` one ``fused_step_poly`` launch per step and nothing else.

The event workloads:

``ball_terminal``: the JAX package's terminal case
(``benchmarks/events_bench.py``): b = 256 free-fall instances dropped from
h0 = linspace(1, 50) at rest, one terminal ground event ``y[0]`` falling
(direction -1), t in [0, 10], rtol 1e-6, atol 1e-9, no dense output.  Every
instance stops at its own impact time sqrt(2 h0 / g).

``vdp_marker``: the JAX package's overhead case (the same file): b = 256
Van der Pol oscillators, mu = 10, y0 = (2, 0) + 0.05 * noise (numpy seed
0), t in [0, 5], the same tolerances, with a non-terminal marker ``y[0]``
(direction 0).  The marker changes neither the trajectory nor the steps, so
a solve without it takes the same vector-field evaluations.

``full_width_long_events``: ``full_width_long`` with E = 2 batched events,
the neural-event-function use (Chen, Amos & Nickel, ICLR 2021): a terminal
event when the per-row state RMS rises through ``EVENTS_LONG
["rms_threshold"]`` and a non-terminal marker on ``y[:, 0]`` (direction 0).
The state RMS grows from ~1 to 18-21 over t in [0, 8]; at 19.5, 54.7 % of
rows 0-63 stop with ``Status.EVENT`` on the CPU and the rest reach t_end.

The gradient workload:

``full_width_train``: ``full_width_long``'s vector field, shapes and tolerance
(b = 1024, f = 784, hidden 1024, weights 3x, t in [0, 8], dense output at
its 64 points) trained through ``ScanAdjoint`` (``TRAIN["max_steps"]`` = 64
steps, the 57 the solve needs and masked no-ops after, checkpointed every
``TRAIN["checkpoint_every"]`` = 16) with ``torch.optim.SGD`` at
``TRAIN["lr"]``.  The weights are float32 leaf tensors that require grad;
the loss is the mean squared error of ``ys`` against a target trajectory
drawn from numpy seed 1.  ``full_width_train(device, reduced=True)`` is its
float64 twin at b = 8, f = 6, hidden 16 (the same structure, seeds and
scales, 1/sqrt(fan_in) at the reduced widths), small enough for the CPU and
for holding the card's gradients to the CPU's.

The stiff workloads (``DiagonallyImplicitRK`` with kvaerno5 and the default
PID controller, float32, final state only), after the JAX package's own stiff
problems:

``vdp_stiff_mixed``: Van der Pol with a per-instance ``mu = 10**linspace(0,
3, b)`` passed as batched args, y0 = (2, 0), t in [0, 2], rtol 1e-4, atol
1e-6 (``tests/test_fused_implicit.py``'s mixed-stiffness batch, spread over
b = 1024 rows): per-instance Newton masks and Jacobian refreshes across four
decades of stiffness in one batch.

``robertson_sweep``: Robertson kinetics (``benchmarks/stiff_bench.py``),
y0 = (1, 0, 0) in every row, t in [0, 100], rtol 1e-5, atol 1e-8, b = 1024:
many Newton iterations per step and frequent refreshes.

``allen_cahn_full``: the Allen-Cahn method of lines of
``benchmarks/stiff_bench.py`` (Dirichlet, ``lam * Lap(y) + y - y**3`` with
lam = (f + 1)**2) at b = 1024, f = 128, y0 = amplitude * sin(pi x) with
amplitudes linspace(1.0, 1.6, b) (the reference's four amplitudes spread over
the batch), t in [0, 5], rtol 1e-4, atol 1e-7: the Newton kernels at width
(J, M and the LU are 64 MiB each).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert
from ..core import Event, pid_controller, polynomial_term

VDP = dict(b=256, f=2, n=200, mu=2.0)
FULL = dict(b=1024, f=784, n=64, hidden=1024)
LONG = dict(weight_scale=3.0, t_end=8.0)
BALL = dict(b=256, g=9.81, t_end=10.0)
MARKER = dict(b=256, mu=10.0, t_end=5.0)
EVENT_TOLS = dict(rtol=1e-6, atol=1e-9)
EVENTS_LONG = dict(rms_threshold=19.5)


def vdp(t, y, mu):
    x, v = y[:, 0], y[:, 1]
    return torch.stack((v, mu * (1 - x**2) * v - x), dim=-1)


def vdp_table3(dtype=np.float32):
    """``(f, y0, t_eval, kwargs)`` of the Table 3 solve, as numpy inputs."""
    mu = VDP["mu"]
    t_cycle = (3.0 - 2.0 * np.log(2.0)) * mu + 2 * np.pi / mu ** (1 / 3)
    rng = np.random.default_rng(0)
    y0 = (np.array([2.0, 0.0]) + 0.1 * rng.standard_normal((VDP["b"], 2))).astype(dtype)
    t_eval = np.linspace(0.0, t_cycle, VDP["n"]).astype(dtype)
    return vdp, y0, t_eval, dict(args=mu, atol=1e-5, rtol=1e-5, max_steps=2000)


def mlp(t, y, p):
    return torch.matmul(torch.tanh(torch.matmul(y, p["w1"]) + p["b1"]), p["w2"]) + p["b2"]


def full_width(device, weight_scale=1.0, t_end=1.0, shape=FULL, dtype=torch.float32):
    """``(f, y0, t_eval, kwargs)`` of the full-width neural-ODE solve; the
    weights are tensors on ``device`` in ``dtype``, ``weight_scale`` times
    the 1/sqrt(fan_in) draws.  ``shape`` gives b, f, n and hidden."""
    b, f, n, h = shape["b"], shape["f"], shape["n"], shape["hidden"]
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    rng = np.random.default_rng(0)
    weights = convert.from_numpy({
        name: weight_scale * w for name, w in (
            ("w1", rng.standard_normal((f, h)) / np.sqrt(f)),
            ("b1", rng.standard_normal(h) / np.sqrt(f)),
            ("w2", rng.standard_normal((h, f)) / np.sqrt(h)),
            ("b2", rng.standard_normal(f) / np.sqrt(h)))},
        device, dtype=dtype)
    y0 = rng.standard_normal((b, f)).astype(np_dtype)
    t_eval = np.linspace(0.0, t_end, n, dtype=np_dtype)
    return mlp, y0, t_eval, dict(method="dopri5", atol=1e-5, rtol=1e-5, args=weights)


def full_width_long(device):
    """``full_width`` with a real step count (see the module docstring)."""
    return full_width(device, **LONG)


TRAIN = dict(max_steps=64, checkpoint_every=16, lr=1e-4, steps=3)
TRAIN_REDUCED = dict(b=8, f=6, n=FULL["n"], hidden=16)


def full_width_train(device, reduced=False):
    """``(f, y0, t_eval, kwargs, target)`` of the training workload (see the
    module docstring): ``kwargs["args"]`` holds the weights, leaf tensors
    that require grad; ``target`` is the (b, n, f) trajectory of the loss,
    a tensor on ``device``.  The solve's own kwargs (tolerances, method) are
    ``full_width_long``'s; ``TRAIN`` has the driver's and SGD's."""
    shape, dtype = (TRAIN_REDUCED, torch.float64) if reduced else (FULL, torch.float32)
    vf, y0, t_eval, kw = full_width(device, shape=shape, dtype=dtype, **LONG)
    for w in kw["args"].values():
        w.requires_grad_(True)
    b, f, n = shape["b"], shape["f"], shape["n"]
    target = torch.as_tensor(np.random.default_rng(1).standard_normal((b, n, f)),
                             dtype=dtype, device=device)
    return vf, y0, t_eval, kw, target


def mse(ys, target):
    """The training loss: the mean squared error of ``ys`` against ``target``."""
    return torch.mean((ys - target) ** 2)


def step_bench(dtype=np.float32):
    """``(vf, y0, None, kw)`` of ``step_bench``; kw sets the span, the
    controller and the tolerances, not the method."""
    b, f = FULL["b"], FULL["f"]
    y0 = np.linspace(0.5, 1.5, b * f, dtype=dtype).reshape(b, f)
    kw = dict(controller=pid_controller(), rtol=1e-4, atol=1e-6, dense=False, t_start=0.0,
              t_end=2.0)
    return polynomial_term(0.0, -1.0), y0, None, kw


def ball(t, y, args):
    """Free fall: y = (height, velocity)."""
    return torch.stack((y[..., 1], torch.full_like(y[..., 1], -BALL["g"])), dim=-1)


GROUND = Event(lambda t, y, args: y[0], terminal=True, direction=-1.0)
MARKER_EVENT = Event(lambda t, y, args: y[0], terminal=False)


def ball_terminal(dtype=np.float32):
    """``(f, y0, None, kwargs)`` of the terminal-event solve; the analytic
    impact times are sqrt(2 * y0[:, 0] / g)."""
    h0 = np.linspace(1.0, 50.0, BALL["b"])
    y0 = np.stack([h0, np.zeros_like(h0)], axis=1).astype(dtype)
    return ball, y0, None, dict(t_start=0.0, t_end=BALL["t_end"], events=GROUND,
                                **EVENT_TOLS)


def vdp_marker(dtype=np.float32):
    """``(f, y0, None, kwargs)`` of the Van der Pol solve with a marker event
    (drop ``kwargs["events"]`` for the same solve without it)."""
    rng = np.random.default_rng(0)
    y0 = (np.array([2.0, 0.0]) + 0.05 * rng.standard_normal((MARKER["b"], 2))).astype(dtype)
    return vdp, y0, None, dict(args=MARKER["mu"], t_start=0.0, t_end=MARKER["t_end"],
                               events=MARKER_EVENT, **EVENT_TOLS)


def _rms_above(t, y):
    return torch.sqrt(torch.mean(y * y, dim=-1)) - EVENTS_LONG["rms_threshold"]


RMS_EVENT = Event(_rms_above, terminal=True, direction=1.0, batched=True, with_args=False)
FIRST_FEATURE = Event(lambda t, y: y[:, 0], terminal=False, batched=True, with_args=False)


def full_width_long_events(device):
    """``full_width_long`` with the RMS-threshold stop and the ``y[:, 0]``
    marker (see the module docstring)."""
    vf, y0, t_eval, kw = full_width_long(device)
    return vf, y0, t_eval, dict(kw, events=(RMS_EVENT, FIRST_FEATURE))


STIFF = dict(b=1024, method="kvaerno5")
ALLEN_CAHN = dict(f=128, t_end=5.0)


def robertson(t, y, args):
    """Robertson kinetics, as ``benchmarks/stiff_bench.py`` writes it."""
    y1, y2, y3 = y[..., 0], y[..., 1], y[..., 2]
    r1 = -0.04 * y1 + 1e4 * y2 * y3
    r3 = 3e7 * y2 * y2
    return torch.stack((r1, -r1 - r3, r3), dim=-1)


def allen_cahn(t, y, lam):
    """Stiff 1D Allen-Cahn semidiscretization (Dirichlet): lam*Lap(y) + y - y^3."""
    up = torch.cat([y[..., 1:], torch.zeros_like(y[..., :1])], dim=-1)
    dn = torch.cat([torch.zeros_like(y[..., :1]), y[..., :-1]], dim=-1)
    return lam * (up - 2.0 * y + dn) + y - y**3


def vdp_stiff_mixed(dtype=np.float32, b=STIFF["b"]):
    """``(f, y0, None, kwargs)`` of the mixed-stiffness Van der Pol solve."""
    mu = (10.0 ** np.linspace(0.0, 3.0, b)).astype(dtype)
    y0 = np.tile(np.array([[2.0, 0.0]], dtype), (b, 1))
    return vdp, y0, None, dict(args=mu, t_start=0.0, t_end=2.0, rtol=1e-4, atol=1e-6,
                               method=STIFF["method"])


def robertson_sweep(dtype=np.float32, b=STIFF["b"]):
    """``(f, y0, None, kwargs)`` of the Robertson solve."""
    y0 = np.tile(np.array([[1.0, 0.0, 0.0]], dtype), (b, 1))
    return robertson, y0, None, dict(t_start=0.0, t_end=100.0, rtol=1e-5, atol=1e-8,
                                     method=STIFF["method"])


def allen_cahn_full(dtype=np.float32, b=STIFF["b"], f=ALLEN_CAHN["f"]):
    """``(f, y0, None, kwargs)`` of the Allen-Cahn method-of-lines solve."""
    x = np.linspace(0.0, 1.0, f + 2)[1:-1]
    amps = np.linspace(1.0, 1.6, b)
    y0 = (amps[:, None] * np.sin(np.pi * x)[None, :]).astype(dtype)
    return allen_cahn, y0, None, dict(args=float((f + 1) ** 2), t_start=0.0,
                                      t_end=ALLEN_CAHN["t_end"], rtol=1e-4, atol=1e-7,
                                      method=STIFF["method"])
