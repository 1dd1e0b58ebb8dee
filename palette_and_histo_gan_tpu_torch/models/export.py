"""Serving export: the networks' inference programs with their weights.

Counterpart of palette_and_histo_gan_tpu/models/export.py (the reference's
keras SavedModel export, side2side_model.py:178-200): `torch.export` turns
an inference function into an `ExportedProgram` that holds its weights,
which `torch.export.save` writes and a serving process loads without the
model code. Inference follows keras SavedModel inference: dropout off
(InstanceNorm keeps no running statistics, so nothing else changes).

The programs take float32 NHWC of a fixed batch, (batch, 64, 64, C), and
compute in the config's compute dtype, as the JAX export does. The weight
files of train/checkpoint.py remain the weight interchange; this module is
the program export.
"""

from __future__ import annotations

import os

import torch
from torch import nn

from ..config import Config

PROGRAM_FILE = "program.pt2"


class GeneratorInference(nn.Module):
    """The generator at serving: dropout off. `UnetGenerator.forward` takes
    a `torch.Generator`, which an exported program cannot take as input."""

    def __init__(self, generator: nn.Module):
        super().__init__()
        self.generator = generator

    def forward(self, source: torch.Tensor) -> torch.Tensor:
        return self.generator(source, None, deterministic=True)


def _check(config: Config) -> None:
    if config.infer_head_conv != "train":
        raise NotImplementedError(
            f"infer_head_conv={config.infer_head_conv!r} is a TPU layout choice the port "
            "does not have; export runs the training head"
        )


def _spec(config: Config, batch_size: int, channels: int, module: nn.Module) -> torch.Tensor:
    device = next(module.parameters()).device
    return torch.zeros(batch_size, config.img_size, config.img_size, channels, device=device)


def export_generator(config: Config, generator: nn.Module,
                     batch_size: int = 1) -> torch.export.ExportedProgram:
    """The generator's inference program, dropout off, on its device:
    (batch, 64, 64, generator_in_channels) float32 -> its output."""
    _check(config)
    spec = _spec(config, batch_size, config.generator_in_channels, generator)
    return torch.export.export(GeneratorInference(generator), (spec,))


def export_discriminator(config: Config, discriminator: nn.Module,
                         batch_size: int = 1) -> torch.export.ExportedProgram:
    """The discriminator's program: (target, source), each (batch, 64, 64,
    discriminator_in_channels) float32 -> (batch, 32, 32, 1) logits."""
    _check(config)
    spec = _spec(config, batch_size, config.discriminator_in_channels, discriminator)
    return torch.export.export(discriminator, (spec, spec.clone()))


def save_exported(config: Config, which: str, program: torch.export.ExportedProgram) -> str:
    """Write models/exported/<which>/<arch>/<model>/program.pt2 (relative
    to the working directory); returns the path."""
    path = os.path.join("models", "exported", which, config.architecture_name, config.model)
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, PROGRAM_FILE)
    torch.export.save(program, out)
    return out


def load_exported(path: str) -> nn.Module:
    """A saved program as a callable module; it needs no model code."""
    return torch.export.load(path).module()


def input_shape(program: nn.Module) -> tuple[int, ...]:
    """The fixed shape of a loaded program's first input."""
    for node in program.graph.nodes:
        if node.op == "placeholder":
            return tuple(node.meta["val"].shape)
    raise ValueError("the program takes no input")
