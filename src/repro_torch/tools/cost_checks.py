"""The counted FLOPs of one reduced prefill against the JAX package's
``launch/hlocost.py``: the case, the reference's count, and the rule that
relates the two (``tests/test_torch_dryrun.py`` holds the count to the
reference's HLO on every CPU run; ``chip_smoke.py`` holds the card
machine's torch to the same number).  And one DTensor matmul on a fake
2 x 2 group against its count by hand (``sharded_matmul``), which holds the
counter's patches of DTensor's private names on whatever torch runs it.

The counter takes the attention at 4 b H hd flops a visible (query, key)
pair; the reference's blocked attention computes every score block that is
not wholly masked (``models/attention.py:_block_pairs``), the masked half of
the diagonal blocks included.  Everything else is the same matmuls.
"""

from __future__ import annotations

import torch

from ..configs import get_config
from ..launch import cost
from ..models import LM
from ..train.steps import make_prefill_step

# Reduced stablelm-3b (2 layers, d = 64, 4 heads of 16, q/kv chunks of 16),
# its prefill of 2 x 64 tokens.
PREFILL_CASE = dict(arch="stablelm-3b", batch=2, seq=64)
# hlocost.analyze(jax.jit(make_prefill_step(cfg)).lower(...).compile()
# .as_text())["flops"] of that case, no mesh.
REFERENCE_PREFILL_FLOPS = 26_804_224.0


def block_area(sq, sk, qc, kc, causal=True, q_offset=0):
    """The (query, key) entries of the score blocks the reference's blocked
    attention computes for one head of one row."""
    nq, nk = -(-sq // qc), -(-sk // kc)
    blocks = sum(1 for qi in range(nq) for ki in range(nk)
                 if ki * kc < sk and not (causal and ki * kc > q_offset + (qi + 1) * qc - 1))
    return blocks * qc * kc


def prefill_flops(device="cpu"):
    """(the counter's FLOPs of ``PREFILL_CASE``'s prefill, run on fake
    tensors, and the same in the reference's attention convention)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = get_config(PREFILL_CASE["arch"], reduced=True)
    b, s = PREFILL_CASE["batch"], PREFILL_CASE["seq"]
    with FakeTensorMode(allow_non_fake_inputs=True):
        model = LM(cfg, device=device, seed=0)
        counted = cost.analyze(make_prefill_step(cfg), model,
                               {"tokens": torch.zeros((b, s), dtype=torch.int32,
                                                      device=device)})["flops"]
    extra = (block_area(s, s, min(cfg.q_chunk, s), min(cfg.kv_chunk, s))
             - cost.visible_pairs(s, s, True))
    return counted, counted + 4.0 * b * cfg.n_heads * cfg.hd * cfg.n_layers * extra


def sharded_matmul():
    """(``cost.analyze``'s counts, the counts by hand) of a Shard(1) matmul
    over "model" gathered whole, and its backward, on a fake 2 x 2 group:
    one all-gather of the (8, 32) float32 output (its largest array, 1024
    bytes) and, for x's gradient (partial over "model"), one all-reduce of
    (8, 64) float32 (2048 bytes).  Per device: the local matmuls are (8, 64)
    x (64, 16) and its two backward products.  Were DTensor's shape
    propagation counted, the global (8, 64) x (64, 32) products would add
    to the FLOPs."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from ..launch.dryrun import fake_process_group

    with fake_process_group(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        with FakeTensorMode():
            x = distribute_tensor(torch.randn(8, 64), mesh, (Replicate(), Replicate()),
                                  src_data_rank=None).requires_grad_()
            w = distribute_tensor(torch.randn(64, 32), mesh, (Replicate(), Shard(1)),
                                  src_data_rank=None).requires_grad_()

            def f(x, w):
                y = (x @ w).redistribute(mesh, (Replicate(), Replicate()))
                gx, gw = torch.autograd.grad(y.sum(), [x, w])
                return gx.full_tensor(), gw

            r = cost.analyze(f, x, w)
    got = {k: r[k] for k in ("flops", "collectives", "argument")}
    want = {"flops": 3 * 2 * 8 * 64 * 16.0,
            "collectives": {"all-gather": 1024.0, "all-reduce": 2048.0,
                            "reduce-scatter": 0.0, "all-to-all": 0.0, "total": 3072.0},
            "argument": 4.0 * (8 * 64 + 64 * 16)}  # x whole, w's local shard
    return got, want
