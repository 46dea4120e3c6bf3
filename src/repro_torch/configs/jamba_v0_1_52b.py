"""Jamba-v0.1-52B [arXiv:2403.19887]: Mamba+attention 1:7 interleave, 16e top-2 MoE
on every other layer.  Period of 8 layers: attention at position 4, MoE at odd
positions -- the published jamba block layout."""

from ..models.config import ArchConfig, MoECfg

_PATTERN = (
    "mamba_mlp",
    "mamba_moe",
    "mamba_mlp",
    "mamba_moe",
    "attn_mlp",
    "mamba_moe",
    "mamba_mlp",
    "mamba_moe",
)

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    pattern=_PATTERN,
    moe=MoECfg(n_experts=16, top_k=2, n_shared=0, d_expert=14336),
    norm="rmsnorm",
    mlp="swiglu",
    rope=False,  # jamba uses no positional encoding (mamba provides position)
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    subquadratic=True,
)

REDUCED = ArchConfig(
    name="jamba-reduced",
    family="hybrid",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    pattern=_PATTERN,
    moe=MoECfg(n_experts=4, top_k=2, n_shared=0, d_expert=128, capacity_factor=8.0),
    norm="rmsnorm",
    mlp="swiglu",
    rope=False,
    ssm_state=8,
    ssm_conv=4,
    ssm_expand=2,
    subquadratic=True,
    q_chunk=16,
    kv_chunk=16,
    dtype="float32",
)
