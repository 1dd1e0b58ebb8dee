"""Training engine: state, losses, the train steps, the chunked loop, Trainer."""

from .losses import bce_with_logits, discriminator_loss, generator_loss
from .state import KerasAdam, TrainState, build_models, create_train_state, param_count
from .steps import (
    discriminate,
    generate,
    indexed_train_step,
    make_train_chunk,
    make_train_step,
    rgba_train_step,
)

__all__ = [
    "bce_with_logits",
    "discriminator_loss",
    "generator_loss",
    "KerasAdam",
    "TrainState",
    "build_models",
    "create_train_state",
    "param_count",
    "discriminate",
    "generate",
    "indexed_train_step",
    "make_train_chunk",
    "make_train_step",
    "rgba_train_step",
]
