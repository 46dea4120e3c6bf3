"""The two workloads that drive the port's main path on the card.

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
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert

VDP = dict(b=256, f=2, n=200, mu=2.0)
FULL = dict(b=1024, f=784, n=64, hidden=1024)
LONG = dict(weight_scale=3.0, t_end=8.0)


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


def full_width(device, weight_scale=1.0, t_end=1.0):
    """``(f, y0, t_eval, kwargs)`` of the full-width neural-ODE solve; the
    weights are float32 tensors on ``device``, ``weight_scale`` times the
    1/sqrt(fan_in) draws."""
    b, f, n, h = FULL["b"], FULL["f"], FULL["n"], FULL["hidden"]
    rng = np.random.default_rng(0)
    weights = convert.from_numpy({
        name: weight_scale * w for name, w in (
            ("w1", rng.standard_normal((f, h)) / np.sqrt(f)),
            ("b1", rng.standard_normal(h) / np.sqrt(f)),
            ("w2", rng.standard_normal((h, f)) / np.sqrt(h)),
            ("b2", rng.standard_normal(f) / np.sqrt(h)))},
        device, dtype=torch.float32)
    y0 = rng.standard_normal((b, f)).astype(np.float32)
    t_eval = np.linspace(0.0, t_end, n, dtype=np.float32)
    return mlp, y0, t_eval, dict(method="dopri5", atol=1e-5, rtol=1e-5, args=weights)


def full_width_long(device):
    """``full_width`` with a real step count (see the module docstring)."""
    return full_width(device, **LONG)
