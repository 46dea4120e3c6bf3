"""Where the LM training step's time goes on the card (``train.make_train_step``,
as ``launch/train`` drives it).

    PYTHONPATH=src python -m repro_torch.tools.profile_train [--arch stablelm-3b]
        [--reduced] [--batch 2] [--seq 2048] [--ode-depth] [--remat]
        [--optimizer adamw|adamw8bit] [--seed 0]

Draws the model's weights on the card from ``--seed`` (full width unless
``--reduced``; ``--ode-depth`` as ``launch/train`` builds it), runs two
training steps as warm-up, a third timed alone and a fourth under
``torch.profiler``, and prints one JSON line: ``step_ms`` (host clock around
the third, synchronized), the peak memory above the state's, and from the
profiler the device operations, the device busy time and idle share, the
port's kernels by name (the attention's forward and backward launches; with
``--ode-depth`` the solver's) and the top device operations by time.
``null`` means the profiler reported no device activity.  It needs a CUDA
device and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from ..configs import get_config
from ..data import SyntheticTokens
from ..optim import AdamWConfig
from ..train import init_train_state, make_train_step
from .profile_step import _profile, _sync_ms


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--arch", default="stablelm-3b")
    parser.add_argument("--reduced", action="store_true")
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--seq", type=int, default=2048)
    parser.add_argument("--ode-depth", action="store_true")
    parser.add_argument("--remat", action="store_true")
    parser.add_argument("--optimizer", default="adamw", choices=("adamw", "adamw8bit"))
    parser.add_argument("--seed", type=int, default=0)
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cfg = get_config(opts.arch, reduced=opts.reduced)
    if opts.ode_depth:
        cfg = dataclasses.replace(cfg, ode_depth=True, n_layers=len(cfg.pattern))
    step_fn = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=10),
                              remat=opts.remat, optimizer=opts.optimizer)
    state = init_train_state(cfg, opts.seed, optimizer=opts.optimizer, device=dev)
    ds = SyntheticTokens(vocab=cfg.vocab, seq_len=opts.seq, global_batch=opts.batch)
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in ds.batch(i).items()}
               for i in range(4)]
    for batch in batches[:2]:
        state, _ = step_fn(state, batch)
    held = {"state": state}

    def step(batch):
        held["state"], metrics = step_fn(held["state"], batch)
        return metrics["loss"]

    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_ms, _ = _sync_ms(lambda: step(batches[2]))
    peak = torch.cuda.max_memory_allocated() - start
    prof = _profile(lambda: step(batches[3]), 1)
    print(json.dumps({"arch": cfg.name, "dtype": cfg.dtype, "ode_depth": opts.ode_depth,
                      "remat": opts.remat, "optimizer": opts.optimizer, "b": opts.batch,
                      "seq": opts.seq, "device": torch.cuda.get_device_name(0),
                      "step_ms": step_ms, "peak_bytes_above_start": peak, "profile": prof}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
