"""The draws of a train step, worked out again from the seeds the benchmark
hands to the program: frozen copies of the port's draw rules.

  * `batch_indices`: palette_and_histo_gan_tpu_torch/data/loader.py::
    batch_indices, a fresh permutation of the n pairs each epoch from a
    generator seeded (data_seed << 32) + epoch, consumed in order, the
    last batch of an epoch wrapping round;
  * `augment_params`: ops/augment.py::draw_params, four uniform rows per
    pair (keep, hue, dy, dx): a hue delta in [-0.5, 0.5) turns, shifts of
    round(U(-0.15, 0.075) * 64) rows and round(U(-0.125, 0.125) * 64)
    columns (half to even), kept with probability `prob`;
  * `dropout_keep`: models/networks.py::DropoutDraw, one uniform draw of
    the whole (B, C, H, W) batch a dropout layer, kept where below
    1 - rate.
The draws run on the device the program ran on, so that the generators'
streams are the same.
"""

from __future__ import annotations

import torch

HEIGHT_FACTOR = (-0.15, 0.075)
WIDTH_FACTOR = (-0.125, 0.125)
MAX_HUE_DELTA = 0.5
SIDE = 64


def batch_indices(data_seed: int, step: int, n: int, batch: int, device) -> torch.Tensor:
    steps_per_epoch = -(-n // batch)
    epoch, in_epoch = divmod(step, steps_per_epoch)
    gen = torch.Generator(device=device)
    gen.manual_seed((data_seed << 32) + epoch)
    perm = torch.randperm(n, generator=gen, device=device)
    return perm[(in_epoch * batch + torch.arange(batch, device=device)) % n]


def augment_params(generator: torch.Generator, batch: int, prob: float):
    """(delta, sy, sx, keep) of `batch` pairs."""
    u = torch.rand((4, batch), generator=generator, device=generator.device)
    choice, u_hue, u_dy, u_dx = u
    delta = -MAX_HUE_DELTA + u_hue * (2 * MAX_HUE_DELTA)
    dy = (HEIGHT_FACTOR[0] + u_dy * (HEIGHT_FACTOR[1] - HEIGHT_FACTOR[0])) * SIDE
    dx = (WIDTH_FACTOR[0] + u_dx * (WIDTH_FACTOR[1] - WIDTH_FACTOR[0])) * SIDE
    return delta, torch.round(dy).long(), torch.round(dx).long(), choice < prob


def dropout_keep(generator: torch.Generator, shape, rate: float) -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=generator, device=generator.device)
    return u < (1.0 - rate)
