"""Palette indexing through kernel K5.

Counterpart of palette_and_histo_gan_tpu/ops/palette_pallas.py: the entry
points of the TPU kernel `_index_kernel`, here ops/palette_kernel.py
(csrc/palette.cu on a CUDA tensor, its plain version on a CPU tensor).
"""

from __future__ import annotations

import torch

from .palette import rgba_to_indexed


def rgba_to_indexed_pallas(image: torch.Tensor, palette: torch.Tensor) -> torch.Tensor:
    """(H, W, 4) image + (256, 4) palette -> (H, W, 1) int32 index map."""
    return rgba_to_indexed(image, palette)


def rgba_to_indexed_pallas_batch(images: torch.Tensor, palettes: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 4) images + (N, 256, 4) palettes -> (N, H, W, 1) int32."""
    return rgba_to_indexed(images, palettes)
