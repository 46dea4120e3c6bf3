"""DeepSeekMoE-16B [arXiv:2401.06066]: fine-grained MoE, 2 shared + 64 routed top-6."""

from ..models.config import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,  # per-expert hidden width (fine-grained experts)
    vocab=102400,
    pattern=("attn_moe",),
    moe=MoECfg(n_experts=64, top_k=6, n_shared=2, d_expert=1408),
    norm="rmsnorm",
    mlp="swiglu",
    rope=True,
)

REDUCED = ArchConfig(
    name="deepseek-moe-16b-reduced",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=48,
    vocab=256,
    pattern=("attn_moe",),
    moe=MoECfg(n_experts=8, top_k=2, n_shared=2, d_expert=48, capacity_factor=8.0),
    norm="rmsnorm",
    mlp="swiglu",
    rope=True,
    q_chunk=16,
    kv_chunk=16,
    dtype="float32",
)
