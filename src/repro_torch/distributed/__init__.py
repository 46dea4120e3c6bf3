"""Sharding across a device mesh (the JAX package's ``repro.distributed``):
the placement rules (``sharding``), the activation anchors and local maps
(``constraints``) and int8 gradient compression (``compression``), on
``torch.distributed`` ``DeviceMesh`` and DTensor."""

from .sharding import (
    batch_spec,
    cache_shardings,
    param_shardings,
    state_shardings,
)

__all__ = ["batch_spec", "cache_shardings", "param_shardings", "state_shardings"]
