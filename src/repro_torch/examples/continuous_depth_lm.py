"""Continuous-depth transformer: the block stack integrated as a neural ODE by
the repro_torch.core batch-parallel solver (weight-tied, adaptive depth per
token batch) -- the direct integration of the paper's technique into the LM
substrate.

    PYTHONPATH=src python -m repro_torch.examples.continuous_depth_lm [--device cpu]
"""

from __future__ import annotations

from ..launch.train import main as train_main
from . import example_device, parser

ITERS = 30


def argv(iters=ITERS):
    """The reference's launcher arguments (``iters`` training steps)."""
    return ["--arch", "stablelm-3b", "--reduced", "--ode-depth", "--steps", str(iters),
            "--batch", "8", "--seq", "64", "--lr", "3e-3"]


def main(device="cuda", iters=ITERS):
    """``launch.train.main`` with the reference's arguments on ``device``;
    returns its result (the losses, the per-step times, the state)."""
    example_device(device)
    return train_main(argv(iters) + ["--device", str(device)])


if __name__ == "__main__":
    main(parser(__doc__).parse_args().device)
