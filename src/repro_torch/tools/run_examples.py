"""Run every example of ``repro_torch.examples`` at the reference's sizes and
iteration counts, one after another in this process, and print one JSON
line each: its wall seconds and final metric (the examples' own asserts
hold or the run fails).

    PYTHONPATH=src python -m repro_torch.tools.run_examples [--device cpu] \\
        [--only cnf_density,latent_ode] [--ckpt-dir DIR]

``train_lm`` writes its checkpoints to ``--ckpt-dir``, by default a new
directory under the temporary directory, removed after the run.  The
example resumes from a checkpoint it finds there, so a run that did not
start at step 0 fails: it would not be the full-length run it is timed as.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import tempfile
import time

import torch

from ..examples import (
    bouncing_ball,
    cnf_density,
    continuous_depth_lm,
    latent_ode,
    quickstart,
    train_lm,
)

NAMES = ("quickstart", "bouncing_ball", "cnf_density", "latent_ode", "train_lm",
         "continuous_depth_lm")


def runs(device, ckpt_dir):
    """{name: (run, its final metric from the run's result)}."""
    return {
        "quickstart": (lambda: quickstart.main(device),
                       lambda r: {"n_steps": r["sol"].stats["n_steps"].tolist()}),
        "bouncing_ball": (lambda: bouncing_ball.main(device),
                          lambda r: {"max_err_vs_closed_form": r["max_err"]}),
        "cnf_density": (lambda: cnf_density.main(device),
                        lambda r: {"final_nll": r["nll"][-1], "iters": len(r["nll"])}),
        "latent_ode": (lambda: (latent_ode.main(device),
                                latent_ode.train_through_service(device=device)),
                       lambda r: {"final_mse": r[0]["mse"][-1], "iters": len(r[0]["mse"]),
                                  "service_loss0": r[1]["loss0"],
                                  "service_final_loss": r[1]["losses"][-1],
                                  "n_grad_solves": r[1]["stats"]["n_grad_solves"]}),
        "train_lm": (lambda: train_lm.main(device=device, ckpt_dir=ckpt_dir),
                     lambda r: {"first_loss": r["losses"][0], "final_loss": r["losses"][-1],
                                "steps": len(r["losses"]), "start": r["start"]}),
        "continuous_depth_lm": (lambda: continuous_depth_lm.main(device),
                                lambda r: {"first_loss": r["losses"][0],
                                           "final_loss": r["losses"][-1],
                                           "steps": len(r["losses"])}),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--only", default=",".join(NAMES))
    ap.add_argument("--ckpt-dir", default=None)
    a = ap.parse_args(argv)
    card = torch.device(a.device).type == "cuda"
    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
           .stdout.strip() if card else "cpu")
    ckpt_dir = a.ckpt_dir or tempfile.mkdtemp(prefix="repro_lm_ckpt_")
    try:
        table = runs(a.device, ckpt_dir)
        for name in a.only.split(","):
            fn, metric = table[name]
            if card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            if card:
                torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            if name == "train_lm" and out["start"] != 0:
                raise SystemExit(f"train_lm resumed at step {out['start']} from a checkpoint "
                                 f"in {ckpt_dir}: not a full-length run; give a fresh "
                                 "--ckpt-dir")
            print(json.dumps({"example": name, "device": a.device, "wall_s": wall_s,
                              **metric(out), "nvidia_smi": smi}), flush=True)
    finally:
        if a.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
