"""Deterministic synthetic token pipeline (the JAX package's
``data/pipeline.py``, which is numpy only; the port keeps its own copy).

Batches are a pure function of (seed, step, row): a restart resumes on the
exact batch boundary with no data lost or repeated, each data-parallel rank
can make only its rows, and any number of batches can be made ahead.  The
generator is a Markov-ish mixture, so the LM loss falls during a short run
(uniform tokens would keep the loss at ln V).  The same seed gives the
reference's batches bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticTokens:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_modes: int = 32

    def batch(self, step: int, *, lo: int = 0, hi: int | None = None):
        """Rows [lo, hi) of the global batch for ``step`` (host numpy)."""
        hi = self.global_batch if hi is None else hi
        rows = []
        for r in range(lo, hi):
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, r])
            )
            # each row follows a random linear-congruential walk over a small
            # mode set -> learnable structure
            mode = rng.integers(self.n_modes)
            a = 1 + 2 * rng.integers(1, 64)
            c = rng.integers(self.vocab)
            x = np.empty(self.seq_len + 1, np.int64)
            x[0] = mode
            for i in range(1, self.seq_len + 1):
                x[i] = (a * x[i - 1] + c) % self.vocab
            noise = rng.random(self.seq_len + 1) < 0.05
            x[noise] = rng.integers(self.vocab, size=noise.sum())
            rows.append(x)
        arr = np.stack(rows).astype(np.int32)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}


def make_batches(ds: SyntheticTokens, start_step: int, n_steps: int):
    for s in range(start_step, start_step + n_steps):
        yield s, ds.batch(s)
