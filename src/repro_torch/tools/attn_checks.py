"""The rule that holds the CUDA attention backward (``flash_attention_bwd``)
and the forward's ``lse`` output to their plain versions on the card;
``chip_smoke.py`` and ``tests/test_torch_train_card.py`` both use it.

- ``lse``: the forward's log-sum-exp within ``LSE_TOL`` = 1e-5 of the plain
  forward's, relative to each row's |lse| (at least 1); both sum in float32
  over up to 2048 keys.  The plain backward is fed the plain forward's
  ``o`` and ``lse``, so a wrong ``lse`` from the kernel shows in the
  gradients too.
- float32: each of dq, dk, dv within ``F32_TOL`` = 1e-4 of the plain
  version's largest entry (the two sum in other orders, over up to 2048
  keys or queries).
- bfloat16: both the kernel and the plain bf16 version are held to a
  float64 oracle (the plain version on float64 copies of the same inputs,
  with its own float64 forward); each gradient's error, relative to the
  oracle's largest entry, at most ``BF16_FACTOR`` = 2 times the plain
  version's.  Both round their float32 sums to bfloat16, so the rounding of
  the output dominates either error.
"""

from __future__ import annotations

import torch

from ..kernels import cuda_impl, ref

F32_TOL = 1e-4
LSE_TOL = 1e-5
BF16_FACTOR = 2.0
NAMES = ("dq", "dk", "dv")

# (b, sq, sk, H, KV, hd, causal, q_offset): GQA and MQA, bidirectional,
# ragged lengths, chunked-prefill continuations, hd = 8 .. 128 (80 is
# stablelm-3b's, 128 qwen2.5-14b's).
CASES = [
    (1, 37, 45, 4, 2, 16, True, 8), (2, 64, 64, 4, 2, 8, True, 0),
    (1, 77, 77, 4, 4, 80, False, 0), (2, 129, 129, 4, 4, 80, True, 0),
    (1, 100, 300, 8, 2, 128, True, 200), (1, 13, 45, 4, 2, 16, True, 32),
    (1, 65, 65, 8, 1, 64, True, 0), (1, 50, 90, 2, 2, 120, False, 0),
]
# The layers the training paths give it: stablelm-3b's (b = 2, s = 2048,
# 32 heads of 80) and a GQA one at qwen2.5-14b's heads (40 / 8 of 128).
LAYERS = {"stablelm-3b_train": (2, 2048, 2048, 32, 32, 80, True, 0),
          "gqa_40_8_128": (2, 2048, 2048, 40, 8, 128, True, 0)}


def inputs(seed, case, dtype, device):
    """q, k, v and a cotangent do of ``case`` from a seeded generator."""
    b, sq, sk, H, KV, hd = case[:6]
    g = torch.Generator(device=device).manual_seed(seed)
    shapes = ((b, sq, H, hd), (b, sk, KV, hd), (b, sk, KV, hd), (b, sq, H, hd))
    return tuple(torch.randn(s, generator=g, device=device).to(dtype) for s in shapes)


def plain_chunks(case):
    """The plain version's chunks: 512 x 1024 as the configs give them."""
    return dict(q_chunk=min(512, case[1]), kv_chunk=min(1024, case[2]))


def rel_errors(got, want):
    """Each gradient's largest error over the largest entry of ``want``."""
    return [float((g.double() - w.double()).abs().max()) / max(float(w.double().abs().max()),
                                                                1e-300)
            for g, w in zip(got, want)]


def hold(label, case, dtype, q, k, v, do, body=None):
    """Run the kernel's forward (with ``lse``) and backward (``body``, or the
    one ``cuda_impl.flash_bwd_body`` picks) on the card tensors, hold them to
    the plain versions by the rule above, and return
    {"rel_err": [...], "plain_rel_err": [...] (bf16), "max_abs_err",
    "lse_rel_err", "out_bitwise_without_lse"}.  Raises AssertionError on a
    violation."""
    causal, q_offset = case[6], case[7]
    out = cuda_impl.flash_attention_fwd(q, k, v, causal=causal, q_offset=q_offset)
    o, lse = cuda_impl.flash_attention_fwd(q, k, v, causal=causal, q_offset=q_offset, lse=True)
    if not torch.equal(out, o):
        raise AssertionError(f"{label}: the output with lse differs from the output without")
    chunks = plain_chunks(case)
    o_plain, lse_plain = ref.flash_attention_fwd(q, k, v, causal=causal, q_offset=q_offset,
                                                 lse=True, **chunks)
    lse_err = float(((lse - lse_plain).abs() / lse_plain.abs().clamp(min=1.0)).max())
    if not lse_err <= LSE_TOL:
        raise AssertionError(f"{label}: lse {lse_err} from the plain forward's, beyond "
                             f"{LSE_TOL}")
    by_body = {} if body is None else {"body": body}
    got = cuda_impl.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, q_offset=q_offset,
                                        **by_body)
    plain = ref.flash_attention_bwd(q, k, v, o_plain, lse_plain.contiguous(), do, causal=causal,
                                    q_offset=q_offset, **chunks)
    res = {"out_bitwise_without_lse": True, "lse_rel_err": lse_err,
           "max_abs_err": max(float((g.float() - p.float()).abs().max())
                              for g, p in zip(got, plain))}
    if dtype == torch.float32:
        res["rel_err"] = rel_errors(got, plain)
        bad = [n for n, e in zip(NAMES, res["rel_err"]) if not e <= F32_TOL]
        if bad:
            raise AssertionError(f"{label}: {bad} beyond {F32_TOL} of the plain version: "
                                 f"{res['rel_err']}")
        return res
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    o64, lse64 = ref.flash_attention_fwd(q64, k64, v64, causal=causal, q_offset=q_offset,
                                         lse=True, **chunks)
    oracle = ref.flash_attention_bwd(q64, k64, v64, o64, lse64, do64, causal=causal,
                                     q_offset=q_offset, **chunks)
    res["rel_err"] = rel_errors(got, oracle)
    res["plain_rel_err"] = rel_errors(plain, oracle)
    bad = [n for n, e, p in zip(NAMES, res["rel_err"], res["plain_rel_err"])
           if not e <= BF16_FACTOR * p]
    if bad:
        raise AssertionError(f"{label}: {bad} err against float64 {res['rel_err']} > "
                             f"{BF16_FACTOR} x the plain bf16 version's {res['plain_rel_err']}")
    return res
