"""Architecture configuration for the model pool (a copy of the JAX
package's ``models/config.py``).

A model is described by a *block pattern* -- the sequence of block kinds in
one period -- repeated ``n_layers / len(pattern)`` times.  The port runs the
layers one ``Block`` module each (``models/lm.py``); the caches keep the
reference's period-stacked layout.  ``q_chunk``/``kv_chunk`` are the block
sizes of the plain attention (``kernels/ref.flash_attention_fwd``); the CUDA
kernel has its own tiles.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    n_shared: int  # shared (always-on) experts
    d_expert: int  # hidden width of each expert
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | vlm | ssm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    # block kinds for one period; see models/transformer.py for kinds
    pattern: tuple[str, ...] = ("attn_mlp",)
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope: bool = True
    rope_theta: float = 10_000.0
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    mlp: str = "swiglu"  # swiglu | gelu
    moe: Optional[MoECfg] = None
    # SSM (mamba) block geometry
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: Optional[int] = None
    # xLSTM geometry
    xlstm_proj: int = 2
    # encoder-decoder (whisper): n_layers counts EACH stack
    enc_dec: bool = False
    # vlm: number of image-embedding tokens provided by the (stub) frontend
    n_img_tokens: int = 0
    # audio: frontend provides precomputed frame embeddings (stub)
    audio_frontend: bool = False
    # continuous-depth mode: integrate the block stack as a neural ODE with the
    # repro.core parallel solver (research option; used on reduced configs)
    ode_depth: bool = False
    ode_steps: int = 8
    # compute dtype for activations/weights in compiled programs
    dtype: str = "bfloat16"
    # attention chunking (flash-style scan) block sizes
    q_chunk: int = 512
    kv_chunk: int = 1024
    # does the arch support sub-quadratic long-context decode?
    subquadratic: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def n_periods(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"pattern length {len(self.pattern)}"
        )
        return self.n_layers // len(self.pattern)

    @property
    def d_inner(self) -> int:  # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank if self.dt_rank is not None else max(1, self.d_model // 16)


# Input-shape cells assigned to every LM arch (seq_len, global_batch, kind).
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}
