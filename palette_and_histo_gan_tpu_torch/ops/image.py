"""Pixel ops on NHWC RGBA tensors: normalization and transparency handling.

Mirrors palette_and_histo_gan_tpu/ops/image.py:14-48.
"""

from __future__ import annotations

import torch


def blacken_transparent_pixels(image: torch.Tensor) -> torch.Tensor:
    """Zero every channel of fully transparent pixels (alpha == 0)."""
    return torch.where(image[..., 3:4] == 0, torch.zeros_like(image), image)


def replace_alpha_with_white(image: torch.Tensor) -> torch.Tensor:
    """Make fully transparent pixels white (255) and drop the alpha channel:
    (..., 4) -> (..., 3). Unused by training; kept for API parity with the
    reference's image utilities."""
    image = torch.where(image[..., 3:4] == 0, torch.full_like(image, 255.0), image)
    return image[..., :3]


def normalize(image: torch.Tensor) -> torch.Tensor:
    """[0, 255] -> [-1, 1]."""
    return image / 127.5 - 1.0


def denormalize(image: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 255]."""
    return (image + 1.0) * 127.5
