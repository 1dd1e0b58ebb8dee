"""Analytic matrix FLOPs of one train step per image: a frozen copy of
palette_and_histo_gan_tpu_torch/utils/flops.py, taken from a configuration
file of configs/ (its `network` and `settings`), not from the program.

Counted: conv and histogram product MACs x 2. Elementwise work (the
histogram's kernel chains, InstanceNorm, activations, Adam) is not, as is
usual for MFU, so a share of peak built on it is a lower bound.
  - conv forward = 2 * H_out * W_out * Cout * Cin * K_h * K_w a sample;
  - a transposed conv k4 s2 touches K^2 / s^2 = 4 taps an output pixel;
  - backward = the input-gradient and the weight-gradient convs, each one
    forward's FLOPs, so a layer that needs both costs 3x its forward.
"""

from __future__ import annotations

import dataclasses

IMG = 64  # the sprites' side


@dataclasses.dataclass(frozen=True)
class Arch:
    """The sizes a count needs, from a configuration file."""

    model: str
    down_filters: tuple
    up_filters: tuple
    generator_in_channels: int
    generator_out_channels: int
    discriminator_in_channels: int
    histogram_size: int

    @property
    def is_indexed(self) -> bool:
        return self.model == "indexed"

    @classmethod
    def of(cls, config: dict) -> "Arch":
        net, settings = config["network"], config["settings"]
        return cls(
            model=config["variant"],
            down_filters=tuple(settings["down_filters"]),
            up_filters=tuple(settings["up_filters"]),
            generator_in_channels=net["generator_in_channels"],
            generator_out_channels=net["generator_out_channels"],
            discriminator_in_channels=net["discriminator_in_channels"],
            histogram_size=settings.get("histogram_size", 64),
        )


def generator_fwd_flops(arch: Arch) -> float:
    total = 0.0
    cin = arch.generator_in_channels
    side = IMG
    skips = []
    for cout in arch.down_filters:  # encoder: conv k4 s2
        side //= 2
        total += 2.0 * side * side * cout * cin * 16
        skips.append(cout)
        cin = cout
    # decoder: transposed conv k4 s2, the skip concats widening the input
    # (the network's input is the last skip)
    skip_sources = list(reversed(skips[:-1])) + [arch.generator_in_channels]
    for cout, skip in zip(arch.up_filters, skip_sources):
        side *= 2
        total += 2.0 * side * side * cout * cin * 4
        cin = cout + skip
    total += 2.0 * side * side * arch.generator_out_channels * cin * 16  # head k4 s1
    return total


def discriminator_fwd_flops(arch: Arch) -> float:
    cin = 2 * arch.discriminator_in_channels  # concat([target, source])
    side = IMG // 2
    total = 2.0 * side * side * 64 * cin * 16  # down block k4 s2
    total += 2.0 * side * side * 1 * 64 * 16  # 1-channel patch head k4 s1
    return total


def histogram_dot_flops(arch: Arch) -> float:
    """The products of one histogram evaluation of one image."""
    s = arch.histogram_size
    return 3 * 2.0 * s * s * IMG * IMG  # three (size, HW) @ (HW, size) planes


def train_step_flops_per_image(arch: Arch) -> float:
    """Matrix FLOPs of one optimization step, per image."""
    g_fwd = generator_fwd_flops(arch)
    d_fwd = discriminator_fwd_flops(arch)
    total = 3.0 * g_fwd  # G: forward + input gradient + weight gradient
    total += 3.0 * d_fwd  # D forwards: fake (G loss), real + fake (D loss)
    # G loss backward through D: one input-gradient pass; D loss backward:
    # weight-gradient passes for both its forwards. The indexed variant's
    # argmax blocks the adversarial gradient: no D input-gradient pass.
    total += 2.0 * d_fwd if arch.is_indexed else 3.0 * d_fwd
    if arch.model == "histogram":
        # real: forward; fake: forward + backward (~1.5x a forward)
        total += histogram_dot_flops(arch) * (1.0 + 1.0 + 1.5)
    return total
