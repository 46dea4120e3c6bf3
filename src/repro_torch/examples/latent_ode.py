"""Latent ODE for irregularly-sampled time series (Rubanova et al., 2019
setting, scaled down): every sequence has its OWN evaluation time grid --
the per-instance t_eval feature that torchode supports natively and joint
solvers cannot express without padding tricks.

Two training loops:

  - ``main()``: the classic in-process loop -- ``torch.autograd`` through
    ``solve_ivp_scan`` over the whole batch (dense per-instance grids).
  - ``train_through_service()``: gradient serving -- every sequence is its
    own request, coalesced by ``SolveService`` into padded batches
    (final-state regime).  Forward requests produce z(t1), the client turns
    the decoder loss into per-request cotangents, and ``GradRequest``s pull
    them back through the coalesced VJP program.  The served gradients are
    asserted bitwise-equal to a solo ``ScanAdjoint`` solve of the same batch
    class through ``CompiledSolver`` before training starts.

    PYTHONPATH=src python -m repro_torch.examples.latent_ode [--device cpu]
"""

from __future__ import annotations

import math

import torch

from ..core import (
    CompiledSolver,
    GradRequest,
    ODETerm,
    ScanAdjoint,
    SolveRequest,
    SolveService,
    Stepper,
    solve_ivp_scan,
)
from . import example_device, parser

KEYS = ("dyn_w1", "dyn_w2", "dec_w", "enc_w")
ITERS, SERVICE_ITERS = 80, 10


def init_params(generator, latent=8, hidden=32, obs=2):
    """The dynamics MLP, the decoder and the encoder, each a normal draw over
    sqrt(fan_in), drawn in that order."""
    def s(shape):
        return torch.randn(shape, generator=generator) / math.sqrt(shape[0])

    return {"dyn_w1": s((latent, hidden)), "dyn_w2": s((hidden, latent)),
            "dec_w": s((latent, obs)), "enc_w": s((obs, latent))}


def dynamics(t, z, p):
    return torch.tanh(z @ p["dyn_w1"]) @ p["dyn_w2"]


def make_data(generator, batch=16, n_obs=12):
    """Spirals observed at random, per-sequence times: t (b, n), xy (b, n, 2)."""
    t = torch.sort(torch.rand((batch, n_obs), generator=generator) * 4.0, dim=1).values
    phase = torch.rand((batch, 1), generator=generator) * 2 * math.pi
    xy = torch.stack([torch.sin(t + phase), torch.cos(t + phase)], -1)
    return t, xy


def _start(device, seed, params, data):
    dev = example_device(device)
    if params is None:
        params = init_params(torch.Generator().manual_seed(seed))
    if data is None:
        data = make_data(torch.Generator().manual_seed(seed))
    params = {k: torch.as_tensor(v).to(dev) for k, v in params.items()}
    t_obs, x_obs = (torch.as_tensor(v).to(dev) for v in data)
    return dev, params, t_obs, x_obs


def main(device="cuda", iters=ITERS, params=None, data=None):
    """80 momentum steps through ``solve_ivp_scan``.  ``params`` / ``data``
    ((t_obs, x_obs)) replace the draws from seed 0 (the run takes their
    dtype), ``iters`` the iteration count; the final MSE's assert is the
    reference's after its 80 iterations, made when ``iters`` reaches them.
    Returns the MSE of every iteration and the final parameters."""
    dev, params, t_obs, x_obs = _start(device, 0, params, data)

    def loss_fn(params):
        z0 = x_obs[:, 0, :] @ params["enc_w"]
        sol = solve_ivp_scan(dynamics, z0, t_obs, args=params, rtol=1e-3, atol=1e-4,
                             max_steps=64, device=dev)  # per-instance time grids!
        pred = sol.ys @ params["dec_w"]
        return torch.mean((pred - x_obs) ** 2)

    lr = 5e-2
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    history = []
    for it in range(iters):
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        mse = loss_fn(p)
        g = dict(zip(p, torch.autograd.grad(mse, list(p.values()))))
        m = {k: 0.9 * m[k] + g[k] for k in m}
        params = {k: params[k] - lr * m[k] for k in params}
        history.append(float(mse.detach()))
        if it % 20 == 0:
            print(f"iter {it:3d}  mse {history[-1]:.4f}")
    print(f"final mse {history[-1]:.4f}")
    if iters >= ITERS:
        assert history[-1] < 0.3
    return {"mse": history, "params": params}


def train_through_service(n_iters=SERVICE_ITERS, lr=5e-2, device="cuda", params=None,
                          data=None):
    """Final-state training where each sequence is a served request.

    The service coalesces the per-sequence requests into one padded batch
    per flush, builds the VJP program once, and every later iteration is a
    cache hit.  Parameter gradients arrive as per-request rows (the
    ``batched_args`` path); the shared dynamics parameters are recovered by
    summing the rows client-side.  ``params`` / ``data`` replace the draws
    from seed 1; the assert that the loss fell is the reference's after its
    10 iterations, made when ``n_iters`` reaches them.  Returns the first
    step's loss, its served gradients (``Grads`` rows stacked: ``y0``,
    ``args``) and the solo solve's, every iteration's loss and the
    service's stats."""
    dev, params, t_obs, x_obs = _start(device, 1, params, data)
    batch = x_obs.shape[0]
    x0, x1 = x_obs[:, 0, :], x_obs[:, -1, :]
    dtype = x0.dtype

    def dyn_single(t, z, p):  # one instance: z (latent,), its own params row
        return torch.tanh(z @ p["dyn_w1"]) @ p["dyn_w2"]

    term = ODETerm(dyn_single, batched=False, batched_args=True)
    drv = ScanAdjoint(Stepper("dopri5"), max_steps=64, rtol=1e-3, atol=1e-4)
    svc = SolveService(max_batch=16, max_delay=None, max_inflight=2, devices=[dev])

    def decode_loss(z1, dec_w):
        return torch.mean((z1 @ dec_w - x1) ** 2)

    spans = [(float(t_obs[i, 0]), float(t_obs[i, -1])) for i in range(batch)]

    def submit(req_cls, params, z0, **kw):
        dyn = {"dyn_w1": params["dyn_w1"], "dyn_w2": params["dyn_w2"]}
        futs = []
        for i, (t0, t1) in enumerate(spans):
            ckw = {k: (v[i] if k == "cotangent" else v) for k, v in kw.items()}
            futs.append(svc.submit(req_cls(f=term, y0=z0[i], t0=t0, t1=t1,
                                           args=dyn, method=drv, **ckw)))
        svc.flush()
        return [f.result() for f in futs]

    def step(params):
        z0 = x0 @ params["enc_w"]
        sols = submit(SolveRequest, params, z0)
        # the service hands results back on the host
        z1 = torch.stack([s.ys[0] for s in sols]).to(dev).requires_grad_()
        dec_w = params["dec_w"].detach().requires_grad_()
        loss = decode_loss(z1, dec_w)
        gz1, gdec = torch.autograd.grad(loss, (z1, dec_w))
        results = submit(GradRequest, params, z0, cotangent=gz1)
        gz0 = torch.stack([g.y0 for _, g in results]).to(dev)
        gdyn = {k: sum(g.args[k] for _, g in results).to(dev) for k in ("dyn_w1", "dyn_w2")}
        genc = x0.T @ gz0
        return loss.detach(), {"dyn_w1": gdyn["dyn_w1"], "dyn_w2": gdyn["dyn_w2"],
                               "dec_w": gdec, "enc_w": genc}, (z0, gz1, results)

    loss0, grads, (z0, gz1, results) = step(params)

    # --- parity: the served gradients ARE the solo ScanAdjoint gradients ---
    # (same batch class: 16 requests fill the bucket exactly)
    solver = CompiledSolver(drv, donate=False)

    def stack(x):
        return torch.stack([torch.as_tensor(x, dtype=dtype, device=dev)] * batch)

    dyn = {"dyn_w1": params["dyn_w1"], "dyn_w2": params["dyn_w2"]}
    ref = solver.solve(
        term, z0, None,
        t_start=torch.tensor([s[0] for s in spans], dtype=dtype, device=dev),
        t_end=torch.tensor([s[1] for s in spans], dtype=dtype, device=dev),
        args={k: stack(v) for k, v in dyn.items()},
        rtol=stack(drv.rtol), atol=stack(drv.atol), cotangent=gz1, device=dev)
    served = {"y0": torch.stack([g.y0 for _, g in results]).to(dev),
              **{k: torch.stack([g.args[k] for _, g in results]).to(dev) for k in dyn}}
    assert torch.equal(served["y0"], ref.grads.y0)
    for k in ("dyn_w1", "dyn_w2"):
        assert torch.equal(served[k], ref.grads.args[k])
    print("served gradients bitwise-equal to solo ScanAdjoint: OK")

    m = {k: torch.zeros_like(v) for k, v in params.items()}
    loss, history = loss0, []
    for it in range(n_iters):
        loss, grads, _ = step(params)
        m = {k: 0.9 * m[k] + grads[k] for k in m}
        params = {k: params[k] - lr * m[k] for k in params}
        history.append(float(loss))
        if it % 5 == 0:
            print(f"iter {it:3d}  final-state mse {history[-1]:.4f}")
    st = svc.stats()
    print(f"final-state mse {float(loss):.4f}  "
          f"(grad solves: {st['n_grad_solves']}, "
          f"grad device time: {st['grad_device_s']:.2f}s)")
    if n_iters >= SERVICE_ITERS:  # momentum may overshoot in the first steps
        assert float(loss) < float(loss0)
    assert st["n_grad_solves"] == (n_iters + 1) * batch
    return {"loss0": float(loss0), "losses": history, "served": served,
            "solo": {"y0": ref.grads.y0, **ref.grads.args}, "stats": st}


if __name__ == "__main__":
    device = parser(__doc__).parse_args().device
    main(device)
    train_through_service(device=device)
