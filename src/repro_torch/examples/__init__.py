"""The JAX package's examples (``examples/*.py``) in the port, one module
each, run as

    PYTHONPATH=src python -m repro_torch.examples.<name> [--device cpu]

``quickstart`` (the paper's Listing 1 and the component API), ``bouncing_ball``
(terminal events and hybrid restarts), ``cnf_density`` (a CNF trained with
the joint adjoint), ``latent_ode`` (per-instance time grids, and gradients
served by ``SolveService``), ``train_lm`` and ``continuous_depth_lm`` (the
training launcher).  Each keeps the reference's functions, sizes, iteration
counts, printed lines and asserts; each ``main`` runs on the card unless
given ``device="cpu"``, and raises where there is no card.
"""

from __future__ import annotations

import argparse

import torch


def example_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; the card raises where there is none
    (an example never carries on on the CPU unasked)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' (--device cpu) "
                           "to run the example on the CPU")
    return dev


def parser(doc: str) -> argparse.ArgumentParser:
    """The examples' command line: ``--device`` (default ``cuda``)."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    return ap
