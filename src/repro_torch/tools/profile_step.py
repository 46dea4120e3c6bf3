"""Where one solver step's time goes on the card, for the workloads of
``chip_smoke.py`` (``tools/workloads.py``).

    PYTHONPATH=src python -m repro_torch.tools.profile_step [--fused]
        [--workload vdp_table3|full_width|full_width_long|step_bench|
                    ball_terminal|vdp_marker|full_width_long_events|
                    vdp_stiff_mixed|robertson_sweep|allen_cahn_full|all]
    PYTHONPATH=src python -m repro_torch.tools.profile_step --grad
    python src/repro_torch/tools/profile_step.py --src <another tree>/src [...]

``--src`` profiles the ``repro_torch`` of another tree (run as a file; it
builds its own kernels), so two trees are compared on one card in one call.

``--fused`` profiles the fused path (``fused=True``: one ``fused_step``
launch per step after the stage sweep; for ``step_bench``, a polynomial
field, one ``fused_step_poly`` launch per step and nothing else) instead of
the unfused one.
``ball_terminal``, ``vdp_marker`` and ``full_width_long_events`` register
events; the last three are the stiff workloads (kvaerno5, the chord-Newton
kernels), the others run dopri5 (``workloads.py``).  Prints one JSON line
per workload (float32):

- ``ms_per_step``: a whole solve's wall time over its loop iterations, the
  driver's per-step host sync (``running.any()``) included;
- ``ms_per_step_no_sync``: the same number of steps issued back to back
  through ``make_solver`` without the loop's own sync, then one synchronize
  (with events each step still reads ``newly.any(dim=0)``);
- ``pid_update_ms``, ``hermite_coeffs_ms``: one call of each plain-torch op
  of the step (host clock, synchronized after 200 calls) -- the ops the
  slice-2 ``fused_step`` kernel folds into one launch;
- with events, ``event_read_ms``: one host read of ``newly.any(dim=0)`` on
  a (b, E) mask, the per-step sync ``events.advance`` adds (host clock, 200
  reads of an idle device: the read's own cost, without the wait for queued
  work it also forces), and ``without_events``: ``ms_per_step``,
  ``ms_per_step_no_sync`` and the profile's operations per step and idle
  share of the same solve with its events taken out;
- with the implicit stepper, ``newton_read_ms``: one host read of
  ``active.any()`` on a (b,) mask, the sync ``newton_solve`` adds per Newton
  iteration (and the Jacobian refresh read per step), timed as
  ``event_read_ms``; ``newton_iters_per_step``: batched Newton iterations
  (each with one such read) per loop iteration;
- ``profile``: from ``torch.profiler`` over the no-sync steps, the device
  operations per step, the device busy time per step, the device idle share
  of that profiled run, the busy time of the port's CUDA kernels in all and
  by kernel (``port_kernels_ms_per_step``), and the top device operations by
  time.
  ``null`` when the profiler reports no device activity.

``--grad`` profiles one training step of ``full_width_train`` instead (a
``ScanAdjoint`` forward of ``TRAIN["max_steps"]`` loop iterations and its
backward, checkpointed every ``TRAIN["checkpoint_every"]`` steps and not
checkpointed), one JSON line each: ``ms_per_training_step``, ``forward_ms``
and ``backward_ms`` (host clock, synchronized), ``peak_bytes``, and from
``torch.profiler`` over one more step the device operations per training
step and per loop iteration, the device busy time, the idle share, the port's
kernels by name, and each backward of ``kernels/autograd.py``
(``backward_ms``: calls, device time and host time of its autograd node, the
kernels it launches included).

It needs a CUDA device and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

# Bound by _bind (main): the tree's repro_torch, this one's or --src's.
make_solver = solve_ivp = ops = workloads = ScanAdjoint = None

BACKWARDS = ("StageAccumBackward", "FusedUpdateBackward", "ErrorNormBackward",
             "InterpEvalBackward")

KERNELS = ("stage_accum_kernel", "fused_update_kernel", "error_norm_kernel",
           "error_norm_row_kernel", "interp_eval_kernel",
           "interp_eval_row_kernel", "interp_eval_cell_kernel", "fused_step_kernel",
           "fused_step_row_kernel",
           "fused_step_poly_row_kernel",
           "masked_bisect_refine_kernel",
           "fused_event_detect_kernel", "fused_event_commit_kernel", "lu_factor_kernel",
           "linsolve_kernel", "newton_iter_kernel", "newton_iter_panel_kernel",
           "newton_iter_warp_kernel", "newton_update_kernel",
           "lu_pivot_kernel", "lu_update_kernel", "substitute_kernel", "lu_factor_staged_kernel",
           "linsolve_staged_kernel", "flash_fwd_kernel", "flash_fwd_wgmma_kernel")


def _sync_ms(fn, reps=1):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps, out


def _steps_without_sync(vf, y0, t_eval, kw, iters, device):
    kw = dict(kw)
    args = kw.pop("args", None)
    if isinstance(args, np.ndarray):
        args = torch.as_tensor(args, device=device)
    kw.pop("max_steps", None)
    span = {k: kw.pop(k) for k in ("t_start", "t_end") if k in kw}
    init, step, _ = make_solver(vf, **kw)
    state, consts = init(torch.as_tensor(y0, device=device), t_eval, args=args, **span)

    def run():
        s = state
        for _ in range(iters):
            s = step(s, consts, args)
        return s

    return run


def _profile(run, iters, backwards=False):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_ms, _ = _sync_ms(run)
    out = _device_summary(prof, wall_ms, iters)
    if out is not None and backwards:
        # Each Function's backward: its autograd node, the kernels it
        # launched included.
        bw = {}
        for a in prof.key_averages():
            name = a.key.rsplit(" ", 1)[-1]
            if a.key.startswith("autograd::engine::evaluate_function") and name in BACKWARDS:
                bw[name] = dict(calls=a.count, device_ms=_device_us(a) / 1e3,
                                host_ms=a.cpu_time_total / 1e3)
        out["backward_ms"] = bw
    return out


def _device_us(avg):
    return getattr(avg, "device_time_total", None) or getattr(avg, "cuda_time_total", 0.0)


def _device_summary(prof, wall_ms, iters):
    kernels = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None
    busy_us = sum(t for _, t in kernels)
    by_name: dict[str, float] = {}
    for name, t in kernels:  # summed by the (80-character) name printed below
        by_name[name[:80]] = by_name.get(name[:80], 0.0) + t
    port: dict[str, float] = {}
    for name, t in by_name.items():
        hits = [k for k in KERNELS if k in name]
        if hits:
            k = max(hits, key=len)
            port[k] = port.get(k, 0.0) + t
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(device_ops_per_step=len(kernels) / iters,
                device_busy_ms_per_step=busy_us / 1e3 / iters,
                device_idle_share=max(0.0, 1.0 - busy_us / 1e3 / wall_ms),
                cuda_kernels_busy_ms_per_step=sum(port.values()) / 1e3 / iters,
                port_kernels_ms_per_step={k: v / 1e3 / iters for k, v in sorted(port.items())},
                top_kernels_ms_per_step={k: v / 1e3 / iters for k, v in top})


def profile_workload(name, vf, y0, t_eval, kw, device):
    solve_ivp(vf, y0, t_eval, device=device, **kw)  # warm-up
    wall, sol = _sync_ms(lambda: solve_ivp(vf, y0, t_eval, device=device, **kw))
    iters = int(sol.stats["n_steps"].max())
    run = _steps_without_sync(vf, y0, t_eval, kw, iters, device)
    run()
    nosync, _ = _sync_ms(run)
    b, f = y0.shape
    g = torch.Generator(device="cpu").manual_seed(0)
    err, dt = torch.rand(b, generator=g).to(device), torch.rand(b, generator=g).to(device)
    one = torch.ones(b, device=device)
    pid, _ = _sync_ms(lambda: ops.pid_update(err, dt, one, one, b1=0.2, b2=0.0, b3=0.0,
                                             safety=0.9, factor_min=0.2, factor_max=10.0,
                                             dt_min=0.0, dt_max=float("inf")), reps=200)
    y = torch.rand(b, f, generator=g).to(device)
    herm, _ = _sync_ms(lambda: ops.hermite_coeffs(y, y, y, y, dt), reps=200)
    out = dict(workload=name, b=b, f=f, iterations=iters, wall_ms=wall,
               ms_per_step=wall / iters, ms_per_step_no_sync=nosync / iters,
               sync_ms_per_step=(wall - nosync) / iters,
               pid_update_ms=pid, hermite_coeffs_ms=herm)
    if kw.get("events"):
        E = len(kw["events"]) if isinstance(kw["events"], tuple) else 1
        newly = torch.rand(b, E, generator=g).to(device) < 0.01
        out["event_read_ms"], _ = _sync_ms(lambda: newly.any(dim=0).tolist(), reps=200)
        out["n_events"] = int(sol.stats["n_events"].sum())
    if "n_newton_iters" in sol.stats:
        active = torch.rand(b, generator=g).to(device) < 0.5
        out["newton_read_ms"], _ = _sync_ms(lambda: bool(active.any()), reps=200)
        # kvaerno5: every evaluation after the initial two is a Newton one.
        out["newton_iters_per_step"] = (int(sol.stats["n_f_evals"][0]) - 2) / iters
    return dict(out, profile=_profile(run, iters))


def profile_grad(device, checkpoint_every):
    """One training step of ``full_width_train`` (see the module docstring)."""
    vf, y0, te, kw, target = workloads.full_width_train(device)
    tr = workloads.TRAIN
    y0t = torch.as_tensor(y0, device=device).requires_grad_()
    drv = ScanAdjoint(max_steps=tr["max_steps"], checkpoint_every=checkpoint_every,
                      rtol=kw["rtol"], atol=kw["atol"])
    times = {}

    def step():
        t0 = time.perf_counter()
        sol = drv.solve(vf, y0t, te, args=kw["args"], device=device)
        loss = workloads.mse(sol.ys, target)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        times.update(forward_ms=(t1 - t0) * 1e3, backward_ms=(time.perf_counter() - t1) * 1e3)
        return sol

    step()  # warm-up
    torch.cuda.reset_peak_memory_stats()
    wall, sol = _sync_ms(step)
    out = dict(workload="full_width_train", checkpoint_every=checkpoint_every,
               max_steps=tr["max_steps"], loop_steps_needed=int(sol.stats["n_steps"].max()),
               ms_per_training_step=wall, **times,
               peak_bytes=torch.cuda.max_memory_allocated())
    prof = _profile(step, 1, backwards=True)
    if prof is not None:
        prof["device_ops_per_loop_iteration"] = prof["device_ops_per_step"] / tr["max_steps"]
    return dict(out, profile=prof)


WORKLOADS = {
    "vdp_table3": lambda device: workloads.vdp_table3(np.float32),
    "full_width": lambda device: workloads.full_width(device),
    "full_width_long": lambda device: workloads.full_width_long(device),
    "step_bench": lambda device: workloads.step_bench(np.float32),
    "ball_terminal": lambda device: workloads.ball_terminal(np.float32),
    "vdp_marker": lambda device: workloads.vdp_marker(np.float32),
    "full_width_long_events": lambda device: workloads.full_width_long_events(device),
    "vdp_stiff_mixed": lambda device: workloads.vdp_stiff_mixed(np.float32),
    "robertson_sweep": lambda device: workloads.robertson_sweep(np.float32),
    "allen_cahn_full": lambda device: workloads.allen_cahn_full(np.float32),
}


def _bind(src):
    """Import the profiled tree's repro_torch (``src``, else the one on the
    path) into this module's globals."""
    global make_solver, solve_ivp, ops, workloads, ScanAdjoint
    if src:
        sys.path.insert(0, str(pathlib.Path(src).resolve()))
    from repro_torch.core import ScanAdjoint, make_solver, solve_ivp
    from repro_torch.kernels import ops
    from repro_torch.tools import workloads


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--fused", action="store_true", help="profile fused=True")
    parser.add_argument("--grad", action="store_true",
                        help="profile a training step of full_width_train instead")
    parser.add_argument("--workload", choices=[*WORKLOADS, "all"], default="all")
    parser.add_argument("--src", default=None,
                        help="the src/ directory whose repro_torch to profile (run as a file)")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device is available", file=sys.stderr)
        return 1
    _bind(opts.src)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    if opts.grad:
        for every in (workloads.TRAIN["checkpoint_every"], 0):
            print(json.dumps({"src": str(pathlib.Path(ops.__file__).parents[2]),
                              **profile_grad(device, every)}), flush=True)
        return 0
    names = list(WORKLOADS) if opts.workload == "all" else [opts.workload]
    for name in names:
        vf, y0, te, kw = WORKLOADS[name](device)
        kw = {"method": "dopri5", **kw, "fused": opts.fused}
        out = profile_workload(name, vf, y0, te, kw, device)
        if kw.get("events"):
            plain = profile_workload(name, vf, y0, te,
                                     {k: v for k, v in kw.items() if k != "events"}, device)
            prof = plain["profile"] or {}
            out["without_events"] = dict(
                iterations=plain["iterations"], ms_per_step=plain["ms_per_step"],
                ms_per_step_no_sync=plain["ms_per_step_no_sync"],
                device_ops_per_step=prof.get("device_ops_per_step"),
                device_idle_share=prof.get("device_idle_share"))
        print(json.dumps({"fused": opts.fused, "src": str(pathlib.Path(ops.__file__).parents[2]),
                          **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
