"""StableLM-3B [hf:stabilityai/stablelm-2]: dense MHA (kv=heads), SwiGLU, LayerNorm."""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab=50304,
    norm="layernorm",
    mlp="swiglu",
    rope=True,
)

REDUCED = ArchConfig(
    name="stablelm-3b-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=160,
    vocab=256,
    norm="layernorm",
    mlp="swiglu",
    rope=True,
    q_chunk=16,
    kv_chunk=16,
    dtype="float32",
)
