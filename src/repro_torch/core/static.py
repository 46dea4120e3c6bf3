"""The static/dynamic split: solver components as hashable config.

A compiled solve program (``core/compiled.py``) is built for one point of
*static* structure and run for any *dynamic* data at that point:

static
    ``ODETerm`` (compared by value; the vector-field callable by identity),
    steppers and their tableaus (coefficients the kernels take by value),
    controllers (filter coefficients), ``Event`` specs and layout choices
    (``dense``, ``dense_window``, ``max_steps``), and every shape, dtype and
    device.  A change builds a new program.
dynamic
    everything with a batch axis -- ``y0``, ``t_eval``/``t_start``/``t_end``,
    ``dt0``, ``args`` leaves, and the tolerances ``rtol``/``atol`` (scalars or
    per-instance vectors; a tolerance change never builds a new program).

The components are frozen dataclasses compared and hashed by value, so two
equal configs key to the same program; ``frozen_setattr``/``freeze`` seal
other classes the same way (mutating a config that is already baked into a
captured program would silently desynchronize the two).

The JAX package registers its components as pytrees (``register_static``,
``register_config_pytree``) so that ``jax.jit`` hashes them into its own
cache key.  PyTorch has no tracer to hand them to: ``CompiledSolver`` builds
its key itself, from a driver's ``static_key()`` (every field but the
tolerances, by value) and ``tree_key`` of each dynamic argument.  Those two
registrations are therefore not ported.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
import torch.utils._pytree as pytree


def frozen_setattr(self, name: str, value: Any) -> None:
    """``__setattr__`` for frozen-after-init classes (see ``freeze``)."""
    if getattr(self, "_frozen", False):
        raise AttributeError(
            f"{type(self).__name__} is frozen: it is static solver config that "
            "may already be baked into a compiled program. Construct a new "
            "instance instead of mutating."
        )
    object.__setattr__(self, name, value)


def freeze(obj: Any) -> None:
    """Seal ``obj`` against further attribute assignment.  Call at the end of
    ``__init__`` in classes whose ``__setattr__`` is ``frozen_setattr``."""
    object.__setattr__(obj, "_frozen", True)


def static_items(obj: Any, exclude: tuple[str, ...] = ()) -> tuple:
    """The instance's attributes as a sorted name/value tuple, skipping
    ``exclude`` and the freeze marker -- the value identity used by the
    ``__eq__``/``__hash__`` of static components and by the drivers'
    ``static_key``."""
    skip = set(exclude) | {"_frozen"}
    return tuple(
        (name, value) for name, value in sorted(vars(obj).items()) if name not in skip
    )


def value_eq(cls: type, exclude: tuple[str, ...] = ()) -> type:
    """Give ``cls`` value-based ``__eq__``/``__hash__`` over its attributes
    (minus ``exclude``), so equal configs key to the same compiled program."""

    def __eq__(self, other):
        if type(other) is not type(self):
            return NotImplemented
        return static_items(self, exclude) == static_items(other, exclude)

    def __hash__(self):
        return hash((cls.__name__, static_items(self, exclude)))

    cls.__eq__ = __eq__
    cls.__hash__ = __hash__
    return cls


class Spec(NamedTuple):
    """The shape, dtype and device of a tensor that does not exist yet: what
    ``CompiledSolver.compile``/``prewarm`` build a program for (the port's
    ``jax.ShapeDtypeStruct``).  ``device`` None means the program's own."""

    shape: tuple
    dtype: torch.dtype
    device: torch.device | None = None


def leaf_key(x) -> Any:
    """Hashable (shape, dtype, device) fingerprint of one dynamic leaf.

    This runs per leaf per call of the compiled front end, so it avoids tree
    machinery for the common cases.  Host scalars key by Python type, as in
    the JAX package: their values are dynamic, and they must not share an
    entry with tensors.  Returns None for a container (the caller flattens)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, x.device)
    if isinstance(x, Spec):
        return (tuple(x.shape), x.dtype, None if x.device is None else torch.device(x.device))
    if isinstance(x, (np.ndarray, np.generic)):
        return (tuple(x.shape), np.dtype(x.dtype), None)
    if isinstance(x, (bool, int, float, complex)):
        return type(x).__name__
    return None


def _is_leaf(x) -> bool:
    return isinstance(x, Spec)


def tree_key(tree) -> Any:
    """Hashable (structure, per-leaf fingerprint) key of a dynamic argument.

    Two trees share a key exactly when they run through the same compiled
    program: the same tree spec (``torch.utils._pytree``) and the same
    per-leaf shape, dtype and device."""
    k = leaf_key(tree)
    if k is not None or tree is None:
        return k
    leaves, spec = pytree.tree_flatten(tree, is_leaf=_is_leaf)
    return (spec, tuple(leaf_key(x) for x in leaves))
