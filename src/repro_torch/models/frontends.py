"""Modality frontend stand-ins (the JAX package's ``models/frontends.py``):
the configs specify the transformer backbone only, and the image patch and
audio frame embeddings its frontends would compute are drawn instead, for
serving and tests.

Each is a normal draw in ``cfg.dtype`` scaled by 0.02, as the reference's.
The reference draws from ``PRNGKey(0)`` (images) and ``PRNGKey(1)``
(audio) by default; here the default generators are seeded 0 and 1 on
``device`` (other numbers: a different RNG).
"""

from __future__ import annotations

import torch


def _normal(shape, dtype, generator, seed, device):
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=generator, dtype=dtype, device=generator.device)
    return x * 0.02


def fake_img_embeds(cfg, batch_size: int, generator=None, device="cuda"):
    """(batch_size, n_img_tokens, d_model) image embeddings in ``cfg.dtype``,
    drawn from ``generator`` (by default one seeded 0 on ``device``)."""
    return _normal((batch_size, cfg.n_img_tokens, cfg.d_model), getattr(torch, cfg.dtype),
                   generator, 0, device)


def fake_audio_embeds(cfg, batch_size: int, n_frames: int, generator=None, device="cuda"):
    """(batch_size, n_frames, d_model) audio frame embeddings in
    ``cfg.dtype``, drawn from ``generator`` (by default one seeded 1 on
    ``device``)."""
    return _normal((batch_size, n_frames, cfg.d_model), getattr(torch, cfg.dtype), generator, 1,
                   device)
