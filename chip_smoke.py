#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (``{"phase": ...}``); any phase that fails
raises, and the script exits non-zero without printing a result:

1. ``device``      the card (``nvidia-smi`` name and power limit), CUDA and nvcc.
2. ``build``       build the CUDA kernels from ``src/repro_torch/kernels/csrc``.
3. ``kernels``     each kernel against its plain PyTorch version on the card,
                   float32 and float64, at the shapes of phases 4 and 5
                   (``torch.testing.assert_close`` at rtol = atol = 1e-5 in
                   float32, 1e-12 in float64: fma contraction and summation
                   order only), with its median time, the plain version's and
                   its bound.
4. ``vdp_table3``  the paper's Table 3 setup (b = 256 Van der Pol, mu = 2,
                   dopri5 then tsit5, tol 1e-5, 200 eval points, float32):
                   solved on the card and on the CPU, with exact kernel
                   launch counts.
5. ``full_width``  a neural-ODE solve at b = 1024, f = 784 (a flattened 28x28
                   image, as in continuous normalising flows on MNIST), hidden
                   width 1024, with the per-instance independence check.

Then the kernel summary line and, last, ``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the repository's ``src/`` beside it, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM (NVIDIA data sheet): HBM3 at 3.35 TB/s; float32 67 TFLOP/s and
# float64 34 TFLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
REPS = 50
SLEEP_CYCLES = 1_000_000  # ~0.5 ms of device time before each timed launch
SOURCE = "src/repro_torch/kernels/csrc/solver_kernels.cu"
REPLACES = {
    "stage_accum": "src/repro/kernels/pallas_impl.py:123",
    "fused_update": "src/repro/kernels/pallas_impl.py:78",
    "error_norm": "src/repro/kernels/pallas_impl.py:167",
    "interp_eval": "src/repro/kernels/pallas_impl.py:226",
}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import convert
    from repro_torch.core import solve_ivp
    from repro_torch.kernels import _build, cuda_impl, ops, ref
    from repro_torch.tools import workloads

    dev = torch.device("cuda")
    # Full float32 products everywhere: the CPU/card comparisons below are
    # about the solver, not about TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ------------------------------------------------------------ 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    emit("device", nvidia_smi=smi, torch=torch.__version__, torch_cuda=torch.version.cuda,
         nvcc=nvcc, name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    # ------------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    fresh = not _build.library_path().exists()
    lib_path = _build.build(verbose=fresh)
    _build.load()
    emit("build", seconds=time.perf_counter() - t0, built=fresh,
         library=str(lib_path.relative_to(ROOT)), flags=" ".join(_build.NVCC_FLAGS))

    # ----------------------------------------------------------- 3. kernels
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MB > 50 MB L2

    def median_ms(fn):
        """Median of REPS launches after warmup, each timed alone with CUDA
        events after the L2 cache is flushed (the main path's callers find
        large operands cold).  The device sleeps before each timed launch,
        so the host has queued the start event, the launch and the end event
        before the device reaches them: host dispatch time stays out of the
        measurement."""
        for _ in range(3):
            fn()
        pairs = []
        for _ in range(REPS):
            flush.zero_()
            torch.cuda._sleep(SLEEP_CYCLES)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)

    def bound_ms(nbytes, flops, dtype):
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]] * 1e3
        return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"

    def tolerance(dtype):
        return 1e-5 if dtype == torch.float32 else 1e-12

    def compare(name, got, want, dtype):
        tol = tolerance(dtype)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        scale = max(float(w.abs().max()) for w in want)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=tol, atol=tol, msg=lambda m: f"{name}: {m}")
        return abs_err, abs_err / max(scale, 1e-300)

    rows = []

    def measure(kernel, shape_name, dtype, label, run_kernel, run_plain, nbytes, flops,
                check_kernel=None):
        """Hold the kernel against its plain version, then time both.
        ``check_kernel`` replaces ``run_kernel`` in the comparison where the
        kernel writes into one of its inputs: it runs the kernel on a copy,
        so both sides see the same inputs."""
        torch.cuda.synchronize()
        want = run_plain()
        got = (check_kernel or run_kernel)()
        abs_err, rel_err = compare(f"{kernel}[{label}]", got, want, dtype)
        bound, by = bound_ms(nbytes, flops, dtype)
        row = dict(kernel=kernel, shape=shape_name, dtype=str(dtype).split(".")[-1],
                   case=label, tol=tolerance(dtype), max_abs_err=abs_err, max_rel_err=rel_err,
                   kernel_ms=median_ms(run_kernel), plain_ms=median_ms(run_plain),
                   bound_ms=bound, bound_by=by, library_ms=None)
        rows.append(row)
        emit("kernels", **row)

    gen = torch.Generator(device="cpu").manual_seed(0)
    coef_rng = np.random.default_rng(0)
    for shape_name, shp in (("vdp_table3", workloads.VDP), ("full_width", workloads.FULL)):
        b, f, n = shp["b"], shp["f"], shp["n"]
        for dtype in (torch.float32, torch.float64):
            e = torch.empty((), dtype=dtype).element_size()

            def r(*s):
                return torch.randn(*s, generator=gen, dtype=dtype).to(dev)

            y, dt, K = r(b, f), 0.1 * r(b).abs(), r(7, b, f)
            a = coef_rng.standard_normal(7)
            for j in range(1, 7):
                Kj = K[:j]
                measure("stage_accum", shape_name, dtype, f"j={j}",
                        lambda: cuda_impl.stage_accum(y, dt, Kj, a[:j]),
                        lambda: ref.stage_accum(y, dt, Kj, a[:j]),
                        e * (b * f * (j + 2) + b), 2 * (j + 1) * b * f)
            bs, be = coef_rng.standard_normal(7), coef_rng.standard_normal(7)
            measure("fused_update", shape_name, dtype, "s=7",
                    lambda: cuda_impl.fused_update(y, K, dt, bs, be),
                    lambda: ref.fused_update(y, K, dt, bs, be),
                    e * (b * f * 10 + b), 4 * 8 * b * f)
            err = 1e-5 * r(b, f)
            for label, (atol, rtol), tol_elems in (
                    ("tol=scalar", (1e-5, 1e-5), 0),
                    ("tol=(b,)", (1e-5 * (1 + r(b).abs()), 1e-5 * (1 + r(b).abs())), 2 * b),
                    ("tol=(b,f)", (1e-5 * (1 + r(b, f).abs()), 1e-5 * (1 + r(b, f).abs())),
                     2 * b * f)):
                measure("error_norm", shape_name, dtype, label,
                        lambda: cuda_impl.error_norm(err, y, K[1], atol, rtol),
                        lambda: ref.error_norm(err, y, K[1], atol, rtol),
                        e * (3 * b * f + tol_elems + b), 7 * b * f)
            # A dense-output write as a step makes it: each row passes a few
            # consecutive eval points (3 here) at its own place in the grid.
            coeffs = tuple(r(b, f) for _ in range(4))
            x = torch.rand(b, n, generator=gen, dtype=dtype).to(dev)
            start = torch.randint(0, n - 3, (b,), generator=gen)
            mask = ((torch.arange(n)[None] >= start[:, None])
                    & (torch.arange(n)[None] < start[:, None] + 3)).to(dev)
            out = r(b, n, f)
            cells, rows_hit = int(mask.sum()), int(mask.any(dim=1).sum())
            # The kernel writes the masked cells of `out` in place; the check
            # runs it on a copy, so a write to an unmasked cell shows up.
            measure("interp_eval", shape_name, dtype, "mask=3 of n per row",
                    lambda: cuda_impl.interp_eval(coeffs, x, mask, out),
                    lambda: ref.interp_eval(coeffs, x, mask, out),
                    e * (cells * f + 4 * rows_hit * f + b * n) + b * n, 6 * cells * f,
                    check_kernel=lambda: cuda_impl.interp_eval(coeffs, x, mask, out.clone()))
            # The windowed write (dense_window > 0) goes through the same kernel.
            W = 8
            cursor = torch.randint(0, n - W + 1, (b,), generator=gen).to(dev)
            xw, mw = x[:, :W].contiguous(), (torch.rand(b, W, generator=gen) < 0.4).to(dev)
            compare("interp_eval[window]",
                    cuda_impl.interp_eval(coeffs, xw, mw, out.clone(), cursor),
                    ref.interp_eval_window(coeffs, xw, mw, out, cursor), dtype)

    # --------------------------------------------------------- 4. vdp_table3
    def reset_launches():
        for k in ops.launches:
            ops.launches[k] = 0

    def timed_solve(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = solve_ivp(*args, **kw)
        torch.cuda.synchronize()
        return sol, (time.perf_counter() - t0) * 1e3

    def expected_launches(stages, iters):
        return {"stage_accum": (stages - 1) * iters, "fused_update": iters,
                "error_norm": iters, "interp_eval": iters}

    vf, y32, t32, kw = workloads.vdp_table3(np.float32)
    _, y64, t64, _ = workloads.vdp_table3(np.float64)
    main_path_launches = {}
    for method in ("dopri5", "tsit5"):
        kw["method"] = method
        solve_ivp(vf, y32, t32, device=dev, **kw)  # warm-up
        reset_launches()
        sol, wall = timed_solve(vf, y32, t32, device=dev, **kw)
        launches = dict(ops.launches)
        card = convert.to_numpy(sol)
        iters = int(card.stats["n_steps"].max())
        want = expected_launches(7, iters)
        check(launches == want, f"vdp_table3/{method}: launches {launches} != {want}")
        check(bool((card.status == 0).all()), f"vdp_table3/{method}: status {card.status}")
        main_path_launches[f"vdp_table3/{method}"] = launches
        # float64, card against CPU: the same algorithm to rounding, so the
        # step counts are equal and ys agree to 1e-9.
        card64 = convert.to_numpy(solve_ivp(vf, y64, t64, device=dev, **kw))
        cpu64 = convert.to_numpy(solve_ivp(vf, y64, t64, device="cpu", **kw))
        check(np.array_equal(card64.stats["n_steps"], cpu64.stats["n_steps"])
              and np.array_equal(card64.status, cpu64.status),
              f"vdp_table3/{method}: float64 card and CPU step counts differ")
        d64 = float(np.abs(card64.ys - cpu64.ys).max())
        check(d64 <= 1e-9, f"vdp_table3/{method}: float64 card vs CPU ys differ by {d64}")
        # float32, card against CPU: rounding differs (fma, pow, summation
        # order), and at tol 1e-5 the embedded error estimate cancels to
        # ~1e-5 of the stage slopes, so a decision near err_ratio = 1 can
        # flip.  Held to: equal status, step counts within 10 %, and ys within
        # the float32 solve's own global error (its distance to a float64
        # solve at tol 1e-10), never looser than 1e-4.
        cpu = convert.to_numpy(solve_ivp(vf, y32, t32, device="cpu", **kw))
        truth = convert.to_numpy(solve_ivp(vf, y64, t64, device=dev, **{
            **kw, "atol": 1e-10, "rtol": 1e-10, "max_steps": 20000}))
        global_err = float(np.abs(card.ys - truth.ys).max())
        d32 = float(np.abs(card.ys - cpu.ys).max())
        dsteps = np.abs(card.stats["n_steps"].astype(int) - cpu.stats["n_steps"])
        same = dsteps == 0
        d32_same = float(np.abs(card.ys[same] - cpu.ys[same]).max()) if same.any() else 0.0
        check(np.array_equal(card.status, cpu.status), f"vdp_table3/{method}: status differs")
        check(np.all(dsteps <= np.ceil(0.1 * cpu.stats["n_steps"])),
              f"vdp_table3/{method}: step counts differ by up to {dsteps.max()}")
        check(d32 <= max(1e-4, global_err),
              f"vdp_table3/{method}: float32 ys differ by {d32} > {max(1e-4, global_err)}")
        emit("vdp_table3", method=method, dtype="float32", b=len(y32),
             mean_steps=float(card.stats["n_steps"].mean()), max_steps=iters, wall_ms=wall,
             ms_per_step=wall / iters, launches=launches, launches_expected=want,
             cpu_max_abs_diff=d32, global_err_vs_tol1e10=global_err,
             instances_equal_steps=int(same.sum()), max_abs_diff_equal_steps=d32_same,
             max_step_count_diff=int(dsteps.max()), float64_cpu_max_abs_diff=d64)

    # --------------------------------------------------------- 5. full_width
    vf, y0, te, kw = workloads.full_width(dev)
    b, n, f = len(y0), len(te), y0.shape[1]
    sub = convert.to_numpy(solve_ivp(vf, y0[:32], te, device=dev, **kw))
    solve_ivp(vf, y0, te, device=dev, **kw)  # warm-up at the full shape
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    sol, wall = timed_solve(vf, y0, te, device=dev, **kw)
    launches = dict(ops.launches)
    main_path_launches["full_width"] = launches
    peak = torch.cuda.max_memory_allocated()
    full = convert.to_numpy(sol)
    iters = int(full.stats["n_steps"].max())
    want = expected_launches(7, iters)
    check(launches == want, f"full_width: launches {launches} != {want}")
    check(np.isfinite(full.ys).all() and full.ys.shape == (b, n, f) and (full.status == 0).all(),
          "full_width: output not finite, not of shape (b, n, f) or not SUCCESS")
    cpu_args = convert.from_numpy({k: v.cpu().numpy() for k, v in kw["args"].items()}, "cpu")
    sub_cpu = convert.to_numpy(solve_ivp(vf, y0[:32], te, device="cpu",
                                         **{**kw, "args": cpu_args}))
    indep = {}
    for label, other in (("card", sub), ("cpu", sub_cpu)):
        match = int((other.stats["n_steps"] == full.stats["n_steps"][:32]).sum())
        diff = float(np.abs(other.ys - full.ys[:32]).max())
        check(match >= 30 and diff <= 1e-3,
              f"full_width: rows 0-31 alone on the {label}: {match}/32 step counts match, "
              f"max ys diff {diff}")
        indep[label] = dict(steps_match_of_32=match, max_abs_diff=diff)
    emit("full_width", b=b, f=f, hidden=workloads.FULL["hidden"], n_eval=n, dtype="float32",
         mean_steps=float(full.stats["n_steps"].mean()), max_steps=iters, wall_ms=wall,
         ms_per_step=wall / iters, launches=launches, max_memory_allocated=peak,
         ys_bytes=b * n * f * 4, independence=indep)

    # ------------------------------------------- kernel summary, then result
    summary = []
    for name in REPLACES:
        mine = [r for r in rows if r["kernel"] == name]
        main = [r for r in mine if r["shape"] == "full_width" and r["dtype"] == "float32"]
        summary.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": main_path_launches["full_width"][name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            # At the full-width float32 shapes; stage_accum and error_norm are
            # the mean over their cases (j = 1..6, the three tolerance shapes).
            "ms": statistics.fmean(r["kernel_ms"] for r in main),
            "plain_ms": statistics.fmean(r["plain_ms"] for r in main),
            "bound_ms": statistics.fmean(r["bound_ms"] for r in main),
            "bound_by": main[0]["bound_by"],
            "library_ms": None,
        })
    check(all(math.isfinite(s["ms"]) for s in summary), "kernel timings are not finite")
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
