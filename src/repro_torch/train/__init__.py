"""Step functions of the port (``repro.train``): the training step and the
two serve steps."""

from .steps import (
    cross_entropy_loss,
    init_train_state,
    make_decode_step,
    make_prefill_step,
    make_train_step,
)

__all__ = [
    "cross_entropy_loss",
    "init_train_state",
    "make_decode_step",
    "make_prefill_step",
    "make_train_step",
]
