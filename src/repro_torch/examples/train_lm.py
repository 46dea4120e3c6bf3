"""End-to-end LM training driver on a reduced assigned architecture --
exercises the full production path: train step, checkpointing, watchdog,
resumable data.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [arch] [steps] [--device cpu]
"""

from __future__ import annotations

from ..launch.train import main as train_main
from . import example_device, parser

CKPT_DIR = "/tmp/repro_lm_ckpt"


def argv(arch="qwen2.5-14b", steps="200", ckpt_dir=CKPT_DIR):
    """The reference's launcher arguments (a checkpoint in ``ckpt_dir`` is
    resumed, as there)."""
    return ["--arch", arch, "--reduced", "--steps", str(steps), "--batch", "16",
            "--seq", "128", "--ckpt-dir", ckpt_dir, "--remat"]


def main(arch="qwen2.5-14b", steps="200", device="cuda", ckpt_dir=CKPT_DIR):
    """``launch.train.main`` with the reference's arguments on ``device``;
    returns its result (the losses, the per-step times, the state)."""
    example_device(device)
    return train_main(argv(arch, steps, ckpt_dir) + ["--device", str(device)])


if __name__ == "__main__":
    ap = parser(__doc__)
    ap.add_argument("arch", nargs="?", default="qwen2.5-14b")
    ap.add_argument("steps", nargs="?", default="200")
    a = ap.parse_args()
    main(a.arch, a.steps, a.device)
