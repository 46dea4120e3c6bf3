"""ODE serving launcher: drive a SolveService with a synthetic request stream.

    PYTHONPATH=src python -m repro_torch.launch.serve_ode \\
        --requests 256 --max-batch 16 --features 2 4 --eval-points 0 8 \\
        --method dopri5 --prewarm --max-inflight 4

Simulates the serving workload the batcher exists for -- a stream of
single-instance solve requests with mixed feature sizes, eval grids, spans
and tolerances (``tools/serve_checks.build_stream``) -- and reports the
service's stats surface (throughput, pad waste, queue/pack/device time
split, in-flight window, bucket/cache behaviour).  Batches start without
waiting on the device and advance block by block on streams of their own;
``--sync`` (or ``--max-inflight 0``) is the blocking service, for
comparison.  ``--device`` (default ``cuda``; without a card it raises)
names the device to serve on; pass ``--device cpu`` to serve on the CPU.
"""

from __future__ import annotations

import argparse
import time

from ..core import SolveService
from ..tools.serve_checks import build_stream, decay, to_requests


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--requests", type=int, default=256)
    parser.add_argument("--max-batch", type=int, default=16)
    parser.add_argument("--deadline-ms", type=float, default=2.0)
    parser.add_argument("--features", type=int, nargs="+", default=[2, 4],
                        help="feature sizes to mix in the stream")
    parser.add_argument("--eval-points", type=int, nargs="+", default=[0, 8],
                        help="eval-grid lengths to mix (0 = final state only)")
    parser.add_argument("--method", default="dopri5")
    parser.add_argument("--prewarm", action="store_true",
                        help="build (and capture) every batch class before the stream")
    parser.add_argument("--max-inflight", type=int, default=4,
                        help="started-but-unharvested batch window "
                             "(0 = blocking service)")
    parser.add_argument("--sync", action="store_true",
                        help="shorthand for --max-inflight 0")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    opts = parser.parse_args(argv)

    svc = SolveService(max_batch=opts.max_batch,
                       max_delay=opts.deadline_ms / 1e3,
                       max_inflight=0 if opts.sync else opts.max_inflight,
                       devices=[opts.device])
    print(f"serving on {len(svc.devices)} device(s), "
          f"max_inflight={svc.max_inflight}")
    stream = to_requests(build_stream(opts.requests, opts.features, opts.eval_points,
                                      opts.seed), decay, method=opts.method)

    if opts.prewarm:
        t0 = time.perf_counter()
        n = sum(svc.prewarm(r) for r in stream[: 4 * len(opts.features)])
        print(f"prewarm: {n} programs in {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    futures = [svc.submit(r) for r in stream]
    svc.flush()
    svc.drain()
    sols = [f.result() for f in futures]
    wall = time.perf_counter() - t0

    ok = sum(bool(s.success.all()) for s in sols)
    print(f"served {len(sols)} requests in {wall:.3f}s "
          f"({len(sols) / wall:.1f} req/s end-to-end), {ok} fully successful")
    stats = svc.stats()
    for name, value in stats.items():
        print(f"  {name:>24}: {value:.4g}" if isinstance(value, float)
              else f"  {name:>24}: {value}")
    return stats


if __name__ == "__main__":
    main()
