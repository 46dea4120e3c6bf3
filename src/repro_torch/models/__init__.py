"""The LM substrate of the port (the JAX package's ``repro.models``): every
block kind of the configs (dense attention and MLP, MoE, Mamba, xLSTM, the
encoder-decoder's cross attention), the image and audio frontends'
stand-ins, prefill and cached decode, on one device or (DTensor weights
under ``distributed.constraints.activation_sharding``) on a mesh."""

from .config import SHAPES, ArchConfig, MoECfg
from .lm import (
    LM,
    decode_step,
    forward,
    init_cache,
    init_params,
    pad_cache,
    param_count,
    prefill,
)

__all__ = [
    "LM",
    "SHAPES",
    "ArchConfig",
    "MoECfg",
    "decode_step",
    "forward",
    "init_cache",
    "init_params",
    "pad_cache",
    "param_count",
    "prefill",
]
