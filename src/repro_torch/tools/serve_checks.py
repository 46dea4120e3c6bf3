"""The request streams that drive ``SolveService`` on the CPU and the card.

Every input is drawn with numpy from a seed, as plain arrays in one dict per
request (``y0``, ``t0``, ``t1``, ``t_eval``, ``args``, ``rtol`` and, for
gradient streams, ``cotangent``), so that the same stream can be served by
the port (``to_requests``) and by the JAX package (its tests build their own
requests from the same dicts).

``make_stream``: the JAX package's ``tests/test_serving_async.py`` stream --
exponential decay ``dy/dt = -y * args`` with per-request rates, features
cycling through 2, 3, 5, a dense grid of 3-8 points on [0.1, 0.7] on every
``dense_every``-th request, t0 ~ U[0, 0.2], t1 ~ U[0.8, 1.2], rtol drawn from
{1e-3, 1e-4, 1e-5}.  ``grad_stream``: the same draws as that package's
``tests/test_serving_grad.py`` gradient requests (a cotangent from a normal
draw per request).  ``build_stream``: ``serve_ode``'s synthetic stream
(mixed feature sizes and eval-grid lengths, t1 ~ U[0.5, 1.5]).

``full_width_stream``: ``full_width_long``'s neural ODE (``tools/
workloads.py``: f = 784, hidden 1024, weights at 3x the 1/sqrt(fan_in)
scale from seed 0) served one request at a time.  The weights are closed
over by one function object, so every request shares one bucket key and no
per-request weights are stacked.  Request i has y0 (784,) from a normal draw
(seed 0), t0 = 0, t1 ~ U[4, 8], rtol from {1e-4, 1e-5} and atol 1e-5; the
even requests ask for the final state only, the odd ones for 50-64
evaluation points on [0, t1] (eval class 64).  ``FULL_STREAM`` holds the
service settings the card serves it with.
"""

from __future__ import annotations

import numpy as np

from ..core import SolveRequest
from . import workloads

FULL_STREAM = dict(requests=4096, max_batch=1024, max_inflight=4, atol=1e-5,
                   t1=(4.0, 8.0), rtols=(1e-4, 1e-5), eval_points=(50, 64))


def decay(t, y, args):
    """Exponential decay with per-row rates: the reference streams' field
    (elementwise, so it runs on torch tensors and JAX arrays alike)."""
    return -y * args


def make_stream(n, seed, feats=(2, 3, 5), dense_every=None, dtype=np.float32):
    """The request dicts of the JAX package's ``make_stream``, drawn in its
    order, with every array in ``dtype``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        feat = int(feats[i % len(feats)])
        n_eval = (None if dense_every is None or i % dense_every
                  else int(rng.integers(3, 9)))
        out.append(dict(
            y0=rng.uniform(0.5, 1.5, (feat,)).astype(dtype),
            t0=float(rng.uniform(0.0, 0.2)),
            t1=float(rng.uniform(0.8, 1.2)),
            t_eval=(None if n_eval is None
                    else np.linspace(0.1, 0.7, n_eval, dtype=np.float32).astype(dtype)),
            args=rng.uniform(0.5, 2.0, (feat,)).astype(dtype),
            rtol=float(rng.choice([1e-3, 1e-4, 1e-5])),
        ))
    return out


def grad_stream(n, seed, feats=(3,), dtype=np.float32):
    """Gradient request dicts, drawn in the order of the JAX package's
    ``make_grad_requests`` (features cycling through ``feats``)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        feat = int(feats[i % len(feats)])
        out.append(dict(
            y0=rng.uniform(0.5, 1.5, (feat,)).astype(dtype),
            t0=float(rng.uniform(0.0, 0.2)),
            t1=float(rng.uniform(0.8, 1.2)),
            args=rng.uniform(0.5, 2.0, (feat,)).astype(dtype),
            rtol=float(rng.choice([1e-3, 1e-4, 1e-5])),
            cotangent=rng.normal(size=(feat,)).astype(dtype),
        ))
    return out


def build_stream(n, features, eval_points, seed, dtype=np.float32):
    """``serve_ode``'s synthetic stream: per request a feature size and an
    eval-grid length (0 = final state only) drawn from the given choices."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        feat = int(rng.choice(features))
        n_eval = int(rng.choice(eval_points))
        out.append(dict(
            y0=rng.uniform(0.5, 1.5, (feat,)).astype(dtype),
            t0=0.0,
            t1=float(rng.uniform(0.5, 1.5)),
            t_eval=np.linspace(0.0, 0.5, n_eval).astype(dtype) if n_eval else None,
            args=np.full((feat,), rng.uniform(0.5, 2.0), dtype),
            rtol=float(rng.choice([1e-3, 1e-4, 1e-5])),
        ))
    return out


def full_width_stream(device, n=FULL_STREAM["requests"], shape=workloads.FULL, seed=0,
                      dtype=np.float32):
    """``(f, dicts)`` of the full-width stream (see the module docstring);
    ``f`` closes over the weights, tensors on ``device``.  ``shape`` gives
    f and hidden (a small one serves the same stream on the CPU)."""
    import torch

    tdtype = torch.float64 if np.dtype(dtype) == np.float64 else torch.float32
    _, _, _, kw = workloads.full_width(device, shape=shape, dtype=tdtype, **workloads.LONG)
    weights = kw["args"]

    def full_width_long_field(t, y, args):
        return workloads.mlp(t, y, weights)

    s = FULL_STREAM
    rng = np.random.default_rng(seed)
    y0 = rng.standard_normal((n, shape["f"])).astype(dtype)
    t1 = rng.uniform(*s["t1"], n)
    rtol = rng.choice(s["rtols"], n)
    n_eval = rng.integers(s["eval_points"][0], s["eval_points"][1] + 1, n)
    out = []
    for i in range(n):
        out.append(dict(
            y0=y0[i], t0=0.0, t1=float(t1[i]),
            t_eval=(np.linspace(0.0, t1[i], n_eval[i]).astype(dtype) if i % 2 else None),
            rtol=float(rtol[i]), atol=s["atol"]))
    return full_width_long_field, out


def to_requests(dicts, f, cls=SolveRequest, **extra):
    """The port's requests (``SolveRequest`` or ``GradRequest``) of a stream
    of dicts, each with ``f`` and the fields in ``extra``."""
    return [cls(f=f, **d, **extra) for d in dicts]
