"""LLaVA-NeXT-34B [hf:llava-hf]: dense decoder backbone + anyres vision frontend
(STUB: input_specs provides precomputed patch embeddings for 576 image tokens)."""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    norm="rmsnorm",
    mlp="swiglu",
    rope=True,
    n_img_tokens=576,
)

REDUCED = ArchConfig(
    name="llava-next-34b-reduced",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab=256,
    norm="rmsnorm",
    mlp="swiglu",
    rope=True,
    n_img_tokens=8,
    q_chunk=16,
    kv_chunk=16,
    dtype="float32",
)
