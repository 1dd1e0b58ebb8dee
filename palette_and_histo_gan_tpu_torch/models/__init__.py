"""The U-Net generator, the PatchGAN discriminator and the Flax weight bridge."""

from . import convert
from .networks import (
    DownBlock,
    InstanceNorm,
    PatchDiscriminator,
    UnetGenerator,
    UpBlock,
    build_discriminator,
    build_generator,
    init_parameters,
)

__all__ = [
    "convert",
    "DownBlock",
    "InstanceNorm",
    "PatchDiscriminator",
    "UnetGenerator",
    "UpBlock",
    "build_discriminator",
    "build_generator",
    "init_parameters",
]
