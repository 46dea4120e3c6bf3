from .adamw import AdamWConfig, adamw_init, adamw_update, clip_by_global_norm, cosine_lr
from .quantized import qadamw_init, qadamw_update

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm", "cosine_lr",
           "qadamw_init", "qadamw_update"]
