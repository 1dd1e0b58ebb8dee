"""Analytic FLOP count of one train step, per image and variant.

The count comes from the configuration alone (its widths, channel counts,
variant and histogram bins), not from a profiler, so that a utilization
(MFU: FLOPs x img/s over the card's peak for the convolutions' dtype) can
be read beside any step time. Counted: the matrix work, conv and histogram
product MACs x 2. Elementwise work (the histogram's kernel chains,
InstanceNorm, activations, Adam) is not counted, as is usual for MFU, so
the share is a lower bound. The JAX package counts the same way; the CPU
tests hold the two counts equal for every variant and width.

Conventions:
  - conv forward FLOPs = 2 * H_out * W_out * Cout * Cin * K_h * K_w (per
    sample);
  - a transposed conv k4 s2 touches K^2 / s^2 = 4 taps an output pixel;
  - backward = the input-gradient conv (= forward FLOPs) + the
    weight-gradient conv (= forward FLOPs), so forward + backward = 3x
    forward for a layer that needs both.
"""

from __future__ import annotations

IMG = 64  # the sprites' side


def _generator_fwd_flops(config) -> float:
    down = list(getattr(config, "down_filters", (64, 128, 256, 512, 512, 512)))
    up = list(getattr(config, "up_filters", (512, 512, 256, 128, 64, 32)))
    total = 0.0
    cin = config.generator_in_channels
    side = IMG
    skips = []
    for cout in down:  # encoder: conv k4 s2
        side //= 2
        total += 2.0 * side * side * cout * cin * 16
        skips.append(cout)
        cin = cout
    # decoder: transposed conv k4 s2, 4 taps an output pixel, the skip
    # concats widening the input (the network's input is the last skip)
    skip_sources = list(reversed(skips[:-1])) + [config.generator_in_channels]
    for cout, skip in zip(up, skip_sources):
        side *= 2
        total += 2.0 * side * side * cout * cin * 4
        cin = cout + skip
    total += 2.0 * side * side * config.generator_out_channels * cin * 16  # head k4 s1
    return total


def _discriminator_fwd_flops(config) -> float:
    cin = 2 * config.discriminator_in_channels  # concat([target, source])
    side = IMG // 2
    total = 2.0 * side * side * 64 * cin * 16  # down block k4 s2
    total += 2.0 * side * side * 1 * 64 * 16  # 1-channel patch head k4 s1
    return total


def _histogram_dot_flops(config) -> float:
    """The products of one histogram evaluation of one image."""
    hw = IMG * IMG
    s = config.histogram_size
    return 3 * 2.0 * s * s * hw  # three (size, HW) @ (HW, size) planes


def train_step_flops_per_image(config) -> float:
    """Analytic matrix FLOPs of one optimization step, per image."""
    g_fwd = _generator_fwd_flops(config)
    d_fwd = _discriminator_fwd_flops(config)
    total = 3.0 * g_fwd  # G: forward + input gradient + weight gradient
    total += 3.0 * d_fwd  # D forwards: fake (G loss), real + fake (D loss)
    # G loss backward through D: one input-gradient pass; D loss backward:
    # weight-gradient passes for both its forwards (real and fake). The
    # indexed variant's argmax blocks the adversarial gradient, so it has
    # no D input-gradient pass, only the two weight-gradient ones.
    total += 2.0 * d_fwd if config.is_indexed else 3.0 * d_fwd
    if config.model == "histogram":
        hist = _histogram_dot_flops(config)
        # real: forward; fake: forward + backward (~1.5x a forward)
        total += hist * (1.0 + 1.0 + 1.5)
    return total
