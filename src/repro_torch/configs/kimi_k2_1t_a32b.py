"""Kimi K2 1T-A32B [arXiv:2501.kimi2, paper-table]: 384-expert top-8 MoE, 1 shared."""

from ..models.config import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,  # per-expert hidden width
    vocab=163840,
    head_dim=112,
    pattern=("attn_moe",),
    moe=MoECfg(n_experts=384, top_k=8, n_shared=1, d_expert=2048),
    norm="rmsnorm",
    mlp="swiglu",
    rope=True,
)

REDUCED = ArchConfig(
    name="kimi-k2-reduced",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=32,
    vocab=256,
    head_dim=16,
    pattern=("attn_moe",),
    moe=MoECfg(n_experts=16, top_k=4, n_shared=1, d_expert=32, capacity_factor=8.0),
    norm="rmsnorm",
    mlp="swiglu",
    rope=True,
    q_chunk=16,
    kv_chunk=16,
    dtype="float32",
)
