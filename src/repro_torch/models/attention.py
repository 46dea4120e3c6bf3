"""GQA attention: the flash-style prefill path and the cached decode path
(the JAX package's ``models/attention.py``).

``flash_attention`` keeps the reference's signature and goes through
``kernels/ops.flash_attention_fwd``: on the CPU the plain port of the pair
schedule (``_block_pairs``) and online softmax, on the card the CUDA kernel
for every shape (ragged lengths and ``q_offset`` included).

Under a mesh (DTensor inputs inside ``activation_sharding``) the kernel runs
on each rank's local shards through ``local_map``, with the reference's GQA
strategy: when the KV heads divide by the model dim, each rank takes its
H / tp query heads and KV / tp key heads; otherwise its contiguous
sq / tp query rows (their causal offset moved by rank * sq / tp) against
the whole keys and values.  ``decode_attention`` is plain torch, as the
reference computes it outside any Pallas kernel; under a mesh it too runs
on local heads (or local rows of the batch with the cache gathered over
the model dim).
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import local_map

from ..distributed.constraints import resolve, tp_size
from ..kernels import ops
from ..kernels.ref import NEG_INF
from ..kernels.ref import flash_pairs as _block_pairs  # noqa: F401  (the reference's name)


def flash_attention(q, k, v, *, causal=True, q_offset=0, q_chunk=512, kv_chunk=1024):
    """q: (b, sq, H, hd); k, v: (b, sk, KV, hd) with H % KV == 0.

    ``q_offset``: absolute position of q[0] relative to k[0] (for chunked
    prefill continuation).  Returns (b, sq, H, hd) in q.dtype.
    """
    if isinstance(q, DTensor):
        return _flash_on_shards(q, k, v, causal=causal, q_offset=q_offset, q_chunk=q_chunk,
                                kv_chunk=kv_chunk)
    return ops.flash_attention_fwd(q, k, v, causal=causal, q_offset=q_offset, q_chunk=q_chunk,
                                   kv_chunk=kv_chunk)


def attention_strategy(KV, sq):
    """"heads", "rows" or "whole": how the attention splits over the model
    dim of the active mapping (the reference's ``head_sharded`` /
    ``seq_sharded``; it splits rows within its q blocks, this port
    contiguous rows, which needs sq % tp == 0)."""
    tp = tp_size() or 1
    if KV % tp == 0:
        return "heads"
    return "rows" if sq % tp == 0 else "whole"


def _flash_on_shards(q, k, v, **kw):
    mesh = q.device_mesh
    sq = q.shape[1]
    how = attention_strategy(k.shape[2], sq)
    qpl = resolve(mesh, "dp", "tp" if how == "rows" else None, "tp" if how == "heads" else None,
                  None, shape=q.shape)
    kvpl = resolve(mesh, "dp", None, "tp" if how == "heads" else None, None, shape=k.shape)
    # in "rows", each model rank's rows see all keys: its k/v gradients are
    # partial sums over the model dim
    kv_grad = tuple(Partial() if how == "rows" and isinstance(a, Replicate) and name == "model"
                    else a for name, a in zip(mesh.mesh_dim_names, kvpl))
    offset = 0
    if how == "rows":
        offset = mesh.get_local_rank("model") * (sq // (tp_size() or 1))
    q_offset = kw.pop("q_offset")

    def local(ql, kl, vl):
        return ops.flash_attention_fwd(ql, kl, vl, q_offset=q_offset + offset, **kw)

    return local_map(local, out_placements=list(qpl), in_placements=(qpl, kvpl, kvpl),
                     in_grad_placements=(qpl, kv_grad, kv_grad), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


def decode_attention(q, k_cache, v_cache, pos):
    """Single-token attention against a (possibly padded) KV cache.

    q: (b, H, hd); k_cache, v_cache: (b, S, KV, hd); pos: (b,) number of valid
    cache entries (the new token's position).  Returns (b, H, hd).
    """
    if isinstance(q, DTensor):
        return _decode_on_shards(q, k_cache, v_cache, pos)
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


def decode_attention_flat(q, k_flat, v_flat, pos):
    """``decode_attention`` on the flat caches (b, S, KV * hd) of
    ``models.lm``; under a mesh on local heads when the KV heads divide by
    the model dim (the cache's flat dim is sharded there), else on local
    batch rows with the cache gathered over the model dim."""
    if isinstance(q, DTensor):
        return _decode_on_shards(q, k_flat, v_flat, pos)
    b, S, D = k_flat.shape
    hd = q.shape[-1]
    return decode_attention(q, k_flat.reshape(b, S, D // hd, hd), v_flat.reshape(b, S, D // hd, hd),
                            pos)


def _decode_on_shards(q, k_flat, v_flat, pos):
    from ..distributed.constraints import as_dtensor

    mesh = q.device_mesh
    heads = attention_strategy(k_flat.shape[2] // q.shape[-1], 1) == "heads"
    qpl = resolve(mesh, "dp", "tp" if heads else None, None, shape=q.shape)
    cpl = resolve(mesh, "dp", None, "tp" if heads else None, shape=k_flat.shape)
    return local_map(decode_attention_flat, out_placements=list(qpl),
                     in_placements=(qpl, cpl, cpl, resolve(mesh, "dp", shape=pos.shape)),
                     device_mesh=mesh,
                     redistribute_inputs=True)(q, k_flat, v_flat, as_dtensor(pos, mesh))
