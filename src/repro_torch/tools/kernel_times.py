"""Times of the redesigned kernels at the main path's shapes, for comparing
two trees of the port on one card.

    PYTHONPATH=src python -m repro_torch.tools.kernel_times [--reps 50]
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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device is available", file=sys.stderr)
        return 1
    if args.src:
        sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from repro_torch.kernels import cuda_impl, ref
    from repro_torch.tools import event_checks, newton_checks, workloads

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

    for b, s in ((4, 2048), (1, 4096)):
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
        M, rhs = newton_checks.to_torch(newton_checks.newton_inputs(f + 5, b, f, npdt), dev)[:2]
        emit(kernel="batched_lu_factor", shape=f"b={b} f={f}", dtype=npdt.__name__,
             ms=median_ms(lambda: cuda_impl.batched_lu_factor(M)),
             library_ms=median_ms(lambda: torch.linalg.lu_factor(M)))
        emit(kernel="batched_linsolve", shape=f"b={b} f={f}", dtype=npdt.__name__,
             ms=median_ms(lambda: cuda_impl.batched_linsolve(M, rhs)),
             library_ms=median_ms(lambda: torch.linalg.solve(M, rhs)))
        for width in (2, 3, f):
            M, rhs, k, fk, mask, scale = newton_checks.to_torch(
                newton_checks.newton_inputs(width + 5, b, width, npdt), dev)
            emit(kernel="masked_newton_update", shape=f"b={b} f={width}", dtype=npdt.__name__,
                 ms=median_ms(lambda: cuda_impl.masked_newton_update(k, rhs, mask, scale)))
            lu, perm = ref.batched_lu_factor(M)
            emit(kernel="fused_newton_iter", shape=f"b={b} f={width}", dtype=npdt.__name__,
                 ms=median_ms(lambda: cuda_impl.fused_newton_iter(lu, perm, k, fk, mask, scale)))
        for eb, ef in ((workloads.FULL["b"], workloads.FULL["f"]),
                       (workloads.MARKER["b"], 2)):
            bargs = event_checks.to_torch(event_checks.bisect_inputs(eb + ef, eb, ef, npdt), dev)
            emit(kernel="masked_bisect_refine", shape=f"b={eb} f={ef}", dtype=npdt.__name__,
                 ms=median_ms(lambda: cuda_impl.masked_bisect_refine(*bargs)))
            *cargs, flags = event_checks.to_torch(
                event_checks.commit_inputs(eb + 2, eb, ef, 2, npdt, "mixed"), dev)
            emit(kernel="fused_event_commit", shape=f"b={eb} f={ef} E=2", dtype=npdt.__name__,
                 ms=median_ms(lambda: cuda_impl.fused_event_commit(*cargs, terminal=flags)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
