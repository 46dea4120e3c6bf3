"""GQA attention: the flash-style prefill path and the cached decode path
(the JAX package's ``models/attention.py``).

``flash_attention`` keeps the reference's signature and goes through
``kernels/ops.flash_attention_fwd``: on the CPU the plain port of the pair
schedule (``_block_pairs``) and online softmax, on the card the CUDA kernel
for every shape (ragged lengths and ``q_offset`` included).  The
reference's sharding constraints are no-ops on one device and are dropped.
``decode_attention`` is plain torch, as the reference computes it outside
any Pallas kernel.
"""

from __future__ import annotations

import math

import torch

from ..kernels import ops
from ..kernels.ref import NEG_INF
from ..kernels.ref import flash_pairs as _block_pairs  # noqa: F401  (the reference's name)


def flash_attention(q, k, v, *, causal=True, q_offset=0, q_chunk=512, kv_chunk=1024):
    """q: (b, sq, H, hd); k, v: (b, sk, KV, hd) with H % KV == 0.

    ``q_offset``: absolute position of q[0] relative to k[0] (for chunked
    prefill continuation).  Returns (b, sq, H, hd) in q.dtype.
    """
    return ops.flash_attention_fwd(q, k, v, causal=causal, q_offset=q_offset, q_chunk=q_chunk,
                                   kv_chunk=kv_chunk)


def decode_attention(q, k_cache, v_cache, pos):
    """Single-token attention against a (possibly padded) KV cache.

    q: (b, H, hd); k_cache, v_cache: (b, S, KV, hd); pos: (b,) number of valid
    cache entries (the new token's position).  Returns (b, H, hd).
    """
    b, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qr = q.reshape(b, KV, G, hd).float() / torch.tensor(math.sqrt(hd), dtype=torch.float32)
    s = torch.einsum("bKGh,bsKh->bKGs", qr, k_cache.float())
    valid = torch.arange(S, device=q.device)[None, :] <= pos[:, None]  # (b, S)
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bKGs,bsKh->bKGh", p, v_cache.float())
    return out.reshape(b, H, hd).to(q.dtype)
