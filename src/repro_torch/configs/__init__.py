"""Architecture registry: one module per assigned arch, each exporting
``CONFIG`` (the exact published geometry) and ``REDUCED`` (a same-family
small config for CPU smoke tests), copied as data from the JAX package's
``configs/``.  The port builds every block kind they use
(``models/transformer.py``)."""

from __future__ import annotations

import importlib

ARCHS = [
    "starcoder2_15b",
    "stablelm_3b",
    "qwen2_5_14b",
    "starcoder2_7b",
    "deepseek_moe_16b",
    "kimi_k2_1t_a32b",
    "jamba_v0_1_52b",
    "llava_next_34b",
    "xlstm_350m",
    "whisper_large_v3",
]

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}
_ALIASES.update({"qwen2.5-14b": "qwen2_5_14b", "jamba-v0.1-52b": "jamba_v0_1_52b"})


def get_config(name: str, reduced: bool = False):
    mod_name = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f".{mod_name}", __package__)
    return mod.REDUCED if reduced else mod.CONFIG


def all_archs():
    return list(ARCHS)
