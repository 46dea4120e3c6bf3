"""The CNF workload of ``benchmarks/cnf_bench.py`` (its lines 25-82) in the
port: an FFJORD-style continuous normalizing flow on 2-D data, the exact
trace of the velocity field's Jacobian in the augmented dynamics.
``examples/cnf_density.py`` trains it; a torch ``cnf_bench`` imports it.

The log-det entry integrates -tr(df/dx) and ``nll_loss`` adds it to log
p(z(1)), as the reference does; the change of variables would add
+integral tr(df/dx), so training contracts the flow without bound (ROADMAP
C-12).  The port keeps the reference's sign, to be held to it.

Random draws take an explicit ``torch.Generator`` (the reference's
``PRNGKey``); they run on the generator's device, and the results are moved
to ``device``.
"""

from __future__ import annotations

import math

import torch

KEYS = ("w1", "w2", "w3")


def init_mlp(generator, dim=2, hidden=64, device=None):
    """{w1 (dim + 1, hidden), w2 (hidden, hidden), w3 (hidden, dim)}, each a
    normal draw over sqrt(fan_in)."""
    def s(shape):
        return torch.randn(shape, generator=generator) / math.sqrt(shape[0])

    out = {"w1": s((dim + 1, hidden)), "w2": s((hidden, hidden)), "w3": s((hidden, dim))}
    return {k: v.to(device) for k, v in out.items()} if device is not None else out


def vf(t, x, params):
    """Plain velocity field f(t, x): (b, dim) -> (b, dim)."""
    tcol = t[:, None].expand(x.shape[0], 1)
    h = torch.cat([x, tcol], -1)
    h = torch.tanh(h @ params["w1"])
    h = torch.tanh(h @ params["w2"])
    return h @ params["w3"]


def aug_dynamics(t, y, params):
    """Augmented CNF state [x (dim), logdet (1)]; the exact trace of each
    row's dim x dim Jacobian by forward mode (``torch.func.jacfwd`` under
    ``vmap``), which the adjoint's ``torch.func.vjp`` differentiates again."""
    x = y[:, :-1]

    def fx(xi, ti):
        return vf(ti[None], xi[None], params)[0]

    def one(xi, ti):
        return torch.func.jacfwd(fx)(xi, ti).diagonal().sum()

    dx = vf(t, x, params)
    div = torch.func.vmap(one)(x, t)
    return torch.cat([dx, -div[:, None]], dim=-1)


def two_moons(generator, n, device=None):
    """n points of the two-moons density with 0.05 Gaussian noise."""
    th = torch.rand((n,), generator=generator) * math.pi
    top = torch.rand((n,), generator=generator) < 0.5
    x = torch.where(top, torch.cos(th), 1 - torch.cos(th))
    y = torch.where(top, torch.sin(th) - 0.25, -torch.sin(th) + 0.25)
    pts = torch.stack([x, y], -1) + 0.05 * torch.randn((n, 2), generator=generator)
    return pts.to(device) if device is not None else pts


def nll_loss(params, x, solve):
    """Mean negative log-likelihood of x under the flow to a standard normal:
    ``solve(y0, t0, t1, params)`` integrates the augmented state 0 -> 1."""
    b, dim = x.shape
    y0 = torch.cat([x, x.new_zeros((b, 1))], -1)
    y1 = solve(y0, 0.0, 1.0, params)
    z, logdet = y1[:, :-1], y1[:, -1]
    logp_z = -0.5 * torch.sum(z**2, -1) - 0.5 * dim * math.log(2 * math.pi)
    return -torch.mean(logp_z + logdet)


def clip_tree(g, max_norm=1.0):
    """The gradient dict scaled to a global norm of at most ``max_norm``."""
    gn = torch.sqrt(sum(torch.sum(x**2) for x in g.values()))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return {k: x * scale for k, x in g.items()}
