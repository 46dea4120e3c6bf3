"""Times of the redesigned kernels at the main path's shapes, for comparing
two trees of the port on one card.

    PYTHONPATH=src python -m repro_torch.tools.kernel_times [--reps 50] [--kernels a,b]
    python src/repro_torch/tools/kernel_times.py --src <another tree>/src

Prints the card (``nvidia-smi`` name and power limit) and one JSON line per
measurement, timed as ``chip_smoke.py``'s ``kernels`` phase times (median
of ``--reps`` launches after warm-up, each after an L2 flush and a device
sleep, CUDA events):

- ``flash_attention_fwd`` in bfloat16 at qwen2.5-14b's layer (40 query / 8
  KV heads, hd = 128, causal) as the full-width serve's prefill gives it (b
  = 4, s = 2048) and at one long prefill (b = 1, s = 4096), beside
  ``scaled_dot_product_attention`` on the same tensors;
- ``batched_lu_factor`` and ``batched_linsolve`` at allen_cahn_full's shape
  (b = 1024, f = 128, the chord matrices of ``tools/newton_checks.py``) in
  float32 and float64, beside ``torch.linalg.lu_factor`` and
  ``torch.linalg.solve``;
- ``fused_newton_iter`` against the plain LU of the same matrices (mixed
  active rows) at allen_cahn_full's shape and at vdp_stiff_mixed's and
  robertson_sweep's (f = 2, 3), float32 and float64;
- ``masked_newton_update`` at allen_cahn_full's shape and at f = 2, 3,
  float32 and float64;
- ``masked_bisect_refine`` (``tools/event_checks.py``'s inputs, mixed active
  rows) and ``fused_event_commit`` (E = 2, terminal and marker events, mixed
  rows) at full_width's shape (b = 1024, f = 784) and vdp_marker's (b = 256,
  f = 2), float32 and float64;
- ``fused_step_poly`` (dopri5, the logistic polynomial, scalar tolerances,
  ``tools/step_checks.py``'s rows) at step_bench's shape (b = 1024, f =
  784) with and without the Hermite coefficients, float32 and float64, and
  at narrow rows (f = 2 at b = 256 and 1024, f = 32, 64 and 128 at b = 1024,
  float32), each body where the tree has two (``ms_by_body``);
- ``fused_step`` (dopri5, integral controller, scalar tolerances,
  coefficients on, f1 = K[-1]) at full_width's shape, float32 and float64,
  and at narrow rows (f = 2 at b = 256, f = 32 and 128 at b = 1024, float32),
  and kvaerno5's fused step at allen_cahn_full's shape (b = 1024, f = 128,
  ``failed`` and ``f0`` set, float32 and float64), each body where the tree
  has two (``ms_by_body``);
- ``stage_accum`` at every stage count j = 1..6 of a dopri5 step, at
  full_width's shape (b = 1024, f = 784) and vdp_table3's (b = 256, f = 2),
  float32 and float64;
- ``fused_update`` at s = 7 (dopri5's weights) at full_width's shape,
  vdp_table3's and allen_cahn_full's (b = 1024, f = 128), float32 and
  float64, at the other stage counts of the repo's tableaus (s = 1, 2, 3, 4)
  at full_width's shape in float32, and at narrow rows (f = 2 to 128 at b =
  1024, float32);
- ``error_norm`` at its three tolerance shapes (scalar, (b,), (b, f)) and
  ``interp_eval`` as a step writes the dense output (3 consecutive of n
  points a row) and its window (W = 8, 3 consecutive points of it a row), at
  full_width's shape (b = 1024, f = 784, n = 64) and vdp_table3's (b = 256,
  f = 2, n = 200), float32 and float64, and at narrow rows (f = 2 to 128 at
  b = 1024, float32; ``error_norm`` with scalar tolerances), each body where
  the tree has two (``ms_by_body``);
- ``error_norm`` on the rows its wide body takes (b x f = 2 x 5 242 880,
  1 x 3 213 072, 37 x 4097, 1024 x 8192), float32 and float64, by every
  body that takes the width, beside the plain version;
- ``flash_attention_bwd`` at ``tools/attn_checks.py``'s two training layers
  in bfloat16, by body, beside SDPA's backward;
- ``fused_event_detect`` (``tools/event_checks.py``'s inputs) at
  full_width_long_events' shape (b = 1024, E = 2), vdp_marker's (b = 256, E
  = 1) and at E = 64 (b = 1024), float32 and float64;
- the launch floor: a one-element PyTorch elementwise op under the same
  timing rule.

Only the wrappers' common arguments are used, so the same script times an
older tree of the port: run as a file with ``--src``, it imports
``repro_torch`` from that directory (which builds its own kernels).  Run it
for two trees in one call, in turns, to compare them on one card.  It needs
a CUDA device and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import itertools
import json
import pathlib
import statistics
import subprocess
import sys


def main(argv=None) -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--src", default=None,
                    help="the src/ directory whose repro_torch to time (run as a file)")
    ap.add_argument("--kernels", default=None,
                    help="comma-separated kernel names to time (default: all)")
    args = ap.parse_args(argv)
    chosen = set(args.kernels.split(",")) if args.kernels else None

    def want(*names):
        return chosen is None or bool(chosen.intersection(names))

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device is available", file=sys.stderr)
        return 1
    if args.src:
        sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from repro_torch.core import get_tableau, integral_controller, pid_controller
    from repro_torch.core.stepper import _tableau_arrays
    from repro_torch.kernels import cuda_impl, ref
    from repro_torch.tools import event_checks, newton_checks, step_checks, workloads

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MB > 50 MB L2

    def median_ms(fn):
        for _ in range(3):
            fn()
        pairs = []
        for _ in range(args.reps):
            flush.zero_()
            torch.cuda._sleep(1_000_000)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)

    tree = str(pathlib.Path(cuda_impl.__file__).resolve().parents[2])

    def emit(**row):
        print(json.dumps({"card": card, "src": tree, **row}), flush=True)

    one = torch.zeros(1, device=dev)
    emit(kernel="launch floor", shape="Tensor.add_ on one element", dtype="float32",
         ms=median_ms(lambda: one.add_(1.0)))

    for b, s in ((4, 2048), (1, 4096)) if want("flash_attention_fwd") else ():
        g = torch.Generator(device=dev).manual_seed(s)
        q = torch.randn(b, s, 40, 128, generator=g, device=dev).bfloat16()
        k, v = (torch.randn(b, s, 8, 128, generator=g, device=dev).bfloat16() for _ in range(2))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        emit(kernel="flash_attention_fwd", shape=f"b={b} s={s} H=40 KV=8 hd=128 causal",
             dtype="bfloat16", ms=median_ms(lambda: cuda_impl.flash_attention_fwd(q, k, v)),
             library_ms=median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=True, enable_gqa=True)))

    b, f = workloads.STIFF["b"], workloads.ALLEN_CAHN["f"]
    for npdt in (np.float32, np.float64):
        dt = npdt.__name__
        M, rhs = newton_checks.to_torch(newton_checks.newton_inputs(f + 5, b, f, npdt), dev)[:2]
        if want("batched_lu_factor"):
            emit(kernel="batched_lu_factor", shape=f"b={b} f={f}", dtype=dt,
                 ms=median_ms(lambda: cuda_impl.batched_lu_factor(M)),
                 library_ms=median_ms(lambda: torch.linalg.lu_factor(M)))
        if want("batched_linsolve"):
            emit(kernel="batched_linsolve", shape=f"b={b} f={f}", dtype=dt,
                 ms=median_ms(lambda: cuda_impl.batched_linsolve(M, rhs)),
                 library_ms=median_ms(lambda: torch.linalg.solve(M, rhs)))
        for width in (2, 3, f) if want("masked_newton_update", "fused_newton_iter") else ():
            M, rhs, k, fk, mask, scale = newton_checks.to_torch(
                newton_checks.newton_inputs(width + 5, b, width, npdt), dev)
            if want("masked_newton_update"):
                emit(kernel="masked_newton_update", shape=f"b={b} f={width}", dtype=dt,
                     ms=median_ms(lambda: cuda_impl.masked_newton_update(k, rhs, mask, scale)))
            if want("fused_newton_iter"):
                lu, perm = ref.batched_lu_factor(M)
                emit(kernel="fused_newton_iter", shape=f"b={b} f={width}", dtype=dt,
                     ms=median_ms(lambda: cuda_impl.fused_newton_iter(lu, perm, k, fk, mask,
                                                                      scale)))
        for eb, ef in ((workloads.FULL["b"], workloads.FULL["f"]),
                       (workloads.MARKER["b"], 2)):
            if want("masked_bisect_refine"):
                bargs = event_checks.to_torch(event_checks.bisect_inputs(eb + ef, eb, ef, npdt),
                                              dev)
                emit(kernel="masked_bisect_refine", shape=f"b={eb} f={ef}", dtype=dt,
                     ms=median_ms(lambda: cuda_impl.masked_bisect_refine(*bargs)))
            if want("fused_event_commit"):
                *cargs, flags = event_checks.to_torch(
                    event_checks.commit_inputs(eb + 2, eb, ef, 2, npdt, "mixed"), dev)
                emit(kernel="fused_event_commit", shape=f"b={eb} f={ef} E=2", dtype=dt,
                     ms=median_ms(lambda: cuda_impl.fused_event_commit(*cargs, terminal=flags)))
        for eb, E in ((workloads.FULL["b"], 2), (workloads.MARKER["b"], 1),
                      (workloads.FULL["b"], 64)) if want("fused_event_detect") else ():
            *dargs, dirs = event_checks.to_torch(event_checks.detect_inputs(eb + E, eb, E, npdt),
                                                 dev)
            emit(kernel="fused_event_detect", shape=f"b={eb} E={E}", dtype=dt,
                 ms=median_ms(lambda: cuda_impl.fused_event_detect(*dargs, directions=dirs)))

    for (b, f), npdt in itertools.product(
            ((workloads.FULL["b"], workloads.FULL["f"]), (workloads.VDP["b"], 2)),
            (np.float32, np.float64)) if want("stage_accum") else ():
        dtype = torch.float32 if npdt == np.float32 else torch.float64
        gen = torch.Generator(device="cpu").manual_seed(b + f)
        y = torch.randn(b, f, generator=gen, dtype=dtype).to(dev)
        dt = 0.1 * torch.rand(b, generator=gen, dtype=dtype).to(dev)
        K = torch.randn(7, b, f, generator=gen, dtype=dtype).to(dev)
        a = np.random.default_rng(0).standard_normal(7)
        for j in range(1, 7):
            emit(kernel="stage_accum", shape=f"b={b} f={f} j={j}", dtype=npdt.__name__,
                 ms=median_ms(lambda j=j: cuda_impl.stage_accum(y, dt, K[:j], a[:j])))

    # fused_update: s = 7 at the main shapes in both dtypes, the other stage
    # counts at full_width's in float32, then narrow rows (b = 1024, float32).
    dopri5 = get_tableau("dopri5")
    full = (workloads.FULL["b"], workloads.FULL["f"])
    update_cases = [(b, f, 7, dtype) for (b, f), dtype in itertools.product(
        (full, (workloads.VDP["b"], workloads.VDP["f"]),
         (workloads.STIFF["b"], workloads.ALLEN_CAHN["f"])), (torch.float32, torch.float64))]
    update_cases += [(*full, s, torch.float32) for s in (1, 2, 3, 4)]
    update_cases += [(workloads.FULL["b"], f, 7, torch.float32)
                     for f in (2, 4, 8, 16, 32, 48, 64, 96, 128)]
    for b, f, s, dtype in update_cases if want("fused_update") else ():
        gen = torch.Generator(device="cpu").manual_seed(b + f)
        y = torch.randn(b, f, generator=gen, dtype=dtype).to(dev)
        dt = 0.1 * torch.rand(b, generator=gen, dtype=dtype).to(dev)
        K = torch.randn(s, b, f, generator=gen, dtype=dtype).to(dev)
        _, _, b_sol, b_err = _tableau_arrays(dopri5, dtype)
        b_sol, b_err = b_sol[:s], b_err[:s]
        emit(kernel="fused_update", shape=f"b={b} f={f} s={s}", dtype=str(dtype).split(".")[-1],
             ms=median_ms(lambda: cuda_impl.fused_update(y, K, dt, b_sol, b_err)))

    # error_norm at its three tolerance shapes, and interp_eval as a step
    # writes the dense output (3 consecutive points of n a row) and its
    # window (W = 8, 3 consecutive points of the window a row), at
    # full_width's and vdp_table3's shapes in float32 and float64, then at
    # narrow rows (b = 1024, float32; error_norm with scalar tolerances),
    # each body where the tree has two.
    norm_bodies = tuple(getattr(cuda_impl, "ERROR_NORM_BODIES", ()))
    interp_bodies = tuple(getattr(cuda_impl, "INTERP_BODIES", ()))

    def by_body(run, bodies, **row):
        row["ms"] = median_ms(run)
        if bodies:
            row["ms_by_body"] = {body: median_ms(lambda body=body: run(body=body))
                                 for body in bodies}
        emit(**row)

    main_shapes = [(workloads.FULL["b"], workloads.FULL["f"], workloads.FULL["n"]),
                   (workloads.VDP["b"], workloads.VDP["f"], workloads.VDP["n"])]
    norm_shapes = [(b, f, n, npdt) for (b, f, n), npdt in itertools.product(
        main_shapes, (np.float32, np.float64))]
    norm_shapes += [(workloads.FULL["b"], f, workloads.FULL["n"], np.float32)
                    for f in (2, 4, 8, 16, 32, 48, 64, 96, 128)]
    for b, f, n, npdt in norm_shapes if want("error_norm", "interp_eval") else ():
        dtype = torch.float32 if npdt == np.float32 else torch.float64
        dt = npdt.__name__
        gen = torch.Generator(device="cpu").manual_seed(b + f)

        def r(*shape):
            return torch.randn(*shape, generator=gen, dtype=dtype).to(dev)

        err, y0, y1 = 1e-5 * r(b, f), r(b, f), r(b, f)
        main = (b, f, n) in main_shapes
        tols = [("scalar", 1e-5, 1e-5)]
        if main:
            tols += [("(b,)", 1e-5 * (1 + r(b).abs()), 1e-5 * (1 + r(b).abs())),
                     ("(b,f)", 1e-5 * (1 + r(b, f).abs()), 1e-5 * (1 + r(b, f).abs()))]
        for label, atol, rtol in tols if want("error_norm") else ():
            by_body(lambda atol=atol, rtol=rtol, **body: cuda_impl.error_norm(
                        err, y0, y1, atol, rtol, **body), norm_bodies,
                    kernel="error_norm", shape=f"b={b} f={f} tol={label}", dtype=dt)
        if not want("interp_eval"):
            continue
        coeffs = tuple(r(b, f) for _ in range(4))
        x = torch.rand(b, n, generator=gen, dtype=dtype).to(dev)
        out = r(b, n, f)

        def run_of(width):
            start = torch.randint(0, width - 2, (b,), generator=gen)[:, None]
            cols = torch.arange(width)[None]
            return ((cols >= start) & (cols < start + 3)).to(dev)

        mask = run_of(n)
        by_body(lambda **body: cuda_impl.interp_eval(coeffs, x, mask, out, **body),
                interp_bodies, kernel="interp_eval", shape=f"b={b} f={f} n={n} mask=3 of n",
                dtype=dt)
        if main:
            W = 8
            cursor = torch.randint(0, n - W + 1, (b,), generator=gen).to(dev)
            xw, mw = x[:, :W].contiguous(), run_of(W)
            by_body(lambda **body: cuda_impl.interp_eval(coeffs, xw, mw, out, cursor, **body),
                    interp_bodies, kernel="interp_eval",
                    shape=f"b={b} f={f} n={n} window W={W} mask=3 of W", dtype=dt)

    # error_norm on the rows the wide body takes -- the ODE-depth LM's (2 x
    # 5 242 880), the joint backsolve's (1 x 3 213 072), one entry past the
    # row body's widest (37 x 4097) and many rows (1024 x 8192) -- float32
    # and float64, scalar tolerances, by every body that takes the width,
    # beside the plain version.
    wide_shapes = ((2, 5242880), (1, 3213072), (37, 4097), (1024, 8192))
    for (b, f), dtype in itertools.product(wide_shapes, (torch.float32, torch.float64)):
        if not want("error_norm") or "wide" not in norm_bodies:
            break
        gen = torch.Generator(device=dev).manual_seed(f)
        err, y0, y1 = (torch.randn(b, f, generator=gen, device=dev, dtype=dtype)
                       for _ in range(3))
        err *= 1e-5
        ms_by_body = {}
        for body in norm_bodies:
            try:
                cuda_impl.check_error_norm_body(body, f)
            except ValueError:
                continue
            ms_by_body[body] = median_ms(lambda body=body: cuda_impl.error_norm(
                err, y0, y1, 1e-5, 1e-5, body=body))
        emit(kernel="error_norm", shape=f"b={b} f={f} tol=scalar", dtype=str(dtype)[6:],
             body=cuda_impl.error_norm_body(f), ms_by_body=ms_by_body,
             plain_ms=median_ms(lambda: ref.error_norm(err, y0, y1, 1e-5, 1e-5)))
        del err, y0, y1

    # The attention backward at the two training layers (bf16; attn_checks'
    # LAYERS) by every body it has, beside SDPA's backward on the same
    # tensors.
    from repro_torch.tools import attn_checks
    bwd_bodies = tuple(getattr(cuda_impl, "FLASH_BWD_BODIES", ()))
    for name, case in attn_checks.LAYERS.items() if want("flash_attention_bwd") else ():
        b, sq, sk, H, KV, hd = case[:6]
        q, k, v, do = attn_checks.inputs(sq + H, case, torch.bfloat16, dev)
        o, lse = cuda_impl.flash_attention_fwd(q, k, v, lse=True)
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
        out_t = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=H != KV)
        do_t = do.transpose(1, 2).contiguous()
        row = dict(kernel="flash_attention_bwd", shape=name, dtype="bfloat16",
                   ms=median_ms(lambda: cuda_impl.flash_attention_bwd(q, k, v, o, lse, do)),
                   sdpa_backward_ms=median_ms(lambda: torch.autograd.grad(
                       out_t, (qt, kt, vt), do_t, retain_graph=True)))
        if bwd_bodies:
            row["ms_by_body"] = {body: median_ms(lambda body=body: cuda_impl.flash_attention_bwd(
                q, k, v, o, lse, do, body=body)) for body in bwd_bodies}
        emit(**row)
        del q, k, v, do, o, lse, qt, kt, vt, out_t, do_t

    # The fused step kernels: fused_step_poly and fused_step by body where
    # the tree has two (a tree with one times its only body).
    bodies = tuple(getattr(cuda_impl, "POLY_BODIES", ()))
    step_bodies = tuple(getattr(cuda_impl, "STEP_BODIES", ()))
    gen = torch.Generator(device="cpu").manual_seed(0)
    tab = get_tableau("dopri5")
    poly = (0.0, 1.0, -1.0)
    shapes = [(workloads.FULL["b"], workloads.FULL["f"], dtype)
              for dtype in (torch.float32, torch.float64)]
    shapes += [(workloads.VDP["b"], 2, torch.float32)] + [
        (workloads.FULL["b"], f, torch.float32) for f in (2, 32, 64, 128)]

    def step_row(shape, dt, run):
        row = dict(kernel="fused_step", shape=shape, dtype=dt, coeffs=True, ms=median_ms(run))
        if step_bodies:
            row["ms_by_body"] = {body: median_ms(lambda body=body: run(body=body))
                                 for body in step_bodies}
        emit(**row)

    for b, f, dtype in shapes if want("fused_step_poly", "fused_step") else ():
        dt = str(dtype).split(".")[-1]
        a, c, b_sol, b_err = _tableau_arrays(tab, dtype)
        y, _, cols, _ = step_checks.step_inputs(b, f, tab.stages, dtype, dev, gen, 4.0)
        f0 = ref.poly_eval(y, poly)
        kw = dict(a=a, c=c, b_sol=b_sol, b_err=b_err, poly=poly, fsal=True, ctrl_mode="pid",
                  ctrl=pid_controller().filter_params(tab.error_order))
        coeff_cases = (False, True) if f == workloads.FULL["f"] else (False,)
        for want_coeffs in coeff_cases if want("fused_step_poly") else ():
            def run(want_coeffs=want_coeffs, **body):
                return cuda_impl.fused_step_poly(y, f0, *cols, 1e-4, 1e-3,
                                                 want_coeffs=want_coeffs, **kw, **body)
            row = dict(kernel="fused_step_poly", shape=f"b={b} f={f} dopri5 logistic",
                       dtype=dt, coeffs=want_coeffs, ms=median_ms(run))
            if bodies:
                row["ms_by_body"] = {body: median_ms(lambda body=body: run(body=body))
                                     for body in bodies}
            emit(**row)
        if f in (2, 32, 128, workloads.FULL["f"]) and want("fused_step"):
            y, K, cols, _ = step_checks.step_inputs(b, f, tab.stages, dtype, dev, gen)
            ctrl = integral_controller().filter_params(tab.error_order)

            def run(**body):
                return cuda_impl.fused_step(y, K, K[-1], *cols, 1e-4, 1e-3, b_sol=b_sol,
                                            b_err=b_err, ctrl=ctrl, want_coeffs=True, **body)
            step_row(f"b={b} f={f} dopri5 integral", dt, run)
    # kvaerno5's fused step at allen_cahn_full's shape: failed and f0 set.
    stiff = get_tableau("kvaerno5")
    for dtype in (torch.float32, torch.float64) if want("fused_step") else ():
        dt = str(dtype).split(".")[-1]
        b, f = workloads.STIFF["b"], workloads.ALLEN_CAHN["f"]
        _, _, b_sol, b_err = _tableau_arrays(stiff, dtype)
        y, K, cols, failed = step_checks.step_inputs(b, f, stiff.stages, dtype, dev, gen)
        f0 = torch.randn(b, f, generator=gen, dtype=dtype).to(dev)
        ctrl = pid_controller().filter_params(stiff.error_order)

        def run(**body):
            return cuda_impl.fused_step(y, K, K[-1], *cols, 1e-7, 1e-4, b_sol=b_sol,
                                        b_err=b_err, ctrl=ctrl, want_coeffs=True,
                                        failed=failed, f0=f0, **body)
        step_row(f"b={b} f={f} kvaerno5 pid failed f0", dt, run)
    return 0


if __name__ == "__main__":
    sys.exit(main())
