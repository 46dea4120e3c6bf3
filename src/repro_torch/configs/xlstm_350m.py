"""xLSTM-350M [arXiv:2405.04517]: mLSTM + sLSTM blocks (3:1 interleave), no FFN
(the xLSTM blocks carry their own up/down projections)."""

from ..models.config import ArchConfig

_PATTERN = ("mlstm", "mlstm", "mlstm", "slstm")

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    pattern=_PATTERN,
    norm="rmsnorm",
    rope=False,
    xlstm_proj=2,
    subquadratic=True,
)

REDUCED = ArchConfig(
    name="xlstm-350m-reduced",
    family="ssm",
    n_layers=4,
    d_model=64,
    n_heads=2,
    n_kv_heads=2,
    d_ff=0,
    vocab=256,
    pattern=_PATTERN,
    norm="rmsnorm",
    rope=False,
    xlstm_proj=2,
    subquadratic=True,
    q_chunk=16,
    kv_chunk=16,
    dtype="float32",
)
