"""Qwen2.5-14B [hf:Qwen]: dense GQA kv=8, QKV bias, SwiGLU, RMSNorm, rope theta 1e6."""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab=152064,
    qkv_bias=True,
    rope=True,
    rope_theta=1e6,
    norm="rmsnorm",
    mlp="swiglu",
)

REDUCED = ArchConfig(
    name="qwen2.5-14b-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab=256,
    qkv_bias=True,
    rope=True,
    rope_theta=1e6,
    norm="rmsnorm",
    mlp="swiglu",
    q_chunk=16,
    kv_chunk=16,
    dtype="float32",
)
