"""StarCoder2-15B [arXiv:2402.19173]: dense, GQA kv=4, RoPE, LayerNorm, GeLU MLP."""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49152,
    norm="layernorm",
    mlp="gelu",
    qkv_bias=True,
    rope=True,
)

REDUCED = ArchConfig(
    name="starcoder2-15b-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab=256,
    norm="layernorm",
    mlp="gelu",
    qkv_bias=True,
    rope=True,
    q_chunk=16,
    kv_chunk=16,
    dtype="float32",
)
