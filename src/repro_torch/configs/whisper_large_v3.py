"""Whisper-large-v3 [arXiv:2212.04356]: encoder-decoder, MHA, GeLU, LayerNorm.
Conv audio frontend is a STUB -- input_specs provides precomputed frame
embeddings.  n_layers counts each stack (32 enc + 32 dec)."""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    pattern=("attn_cross_mlp",),
    norm="layernorm",
    mlp="gelu",
    rope=False,  # whisper uses learned/sinusoidal pos-emb; stub embeds include it
    enc_dec=True,
    audio_frontend=True,
)

REDUCED = ArchConfig(
    name="whisper-large-v3-reduced",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    pattern=("attn_cross_mlp",),
    norm="layernorm",
    mlp="gelu",
    rope=False,
    enc_dec=True,
    audio_frontend=True,
    q_chunk=16,
    kv_chunk=16,
    dtype="float32",
)
