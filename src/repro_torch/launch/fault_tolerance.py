"""Fault tolerance for the training launcher (the JAX package's
``launch/fault_tolerance.py``): a step watchdog and a restart supervisor.

1. Frequent async checkpoints (``checkpoint/store.py``): atomic, bounded
   queue, host copies taken before the next step.
2. A step WATCHDOG: every train step must end within ``timeout_s``; a
   straggling or hung step raises, and the supervisor restarts from the
   latest checkpoint.
3. Data determinism: the pipeline is a pure function of (seed, step), so a
   restart replays no data and skips none.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable

import torch


class StepTimeout(RuntimeError):
    pass


@dataclasses.dataclass
class Watchdog:
    """Wall-clock watchdog around blocking step calls (SIGALRM-based; call
    from the main thread)."""

    timeout_s: float = 300.0

    def run(self, fn: Callable, *args):
        def _handler(signum, frame):
            raise StepTimeout(f"step exceeded {self.timeout_s}s (straggler/hang)")

        old = signal.signal(signal.SIGALRM, _handler)
        signal.setitimer(signal.ITIMER_REAL, self.timeout_s)
        try:
            out = fn(*args)
            # wait for the queued device work: a hung kernel surfaces here
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            return out
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, old)


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 3
    backoff_s: float = 1.0

    def supervise(self, make_and_run: Callable[[], None]):
        """Run ``make_and_run`` (which restores from the latest checkpoint on
        entry) and restart it on failure up to ``max_restarts`` times."""
        attempts = 0
        while True:
            try:
                return make_and_run()
            except (StepTimeout, RuntimeError) as e:  # noqa: PERF203
                attempts += 1
                if attempts > self.max_restarts:
                    raise
                print(f"[fault-tolerance] restart {attempts} after: {e}")
                time.sleep(self.backoff_s * attempts)
