"""The fused histogram, v1: `histogram_impl="pallas"`.

Counterpart of palette_and_histo_gan_tpu/ops/histogram_pallas.py: the
forward is kernel K3a and the backward kernel K4a (ops/histogram_kernel.py,
csrc/histogram.cu), both with a float32 chain whatever the compute dtype,
as the JAX step drops `dtype` for this implementation.
"""

from __future__ import annotations

import torch

from . import histogram_kernel as hk


def calculate_rgbuv_histogram_pallas(
    image_batch: torch.Tensor,
    size: int = 64,
    method: str = "inverse-quadratic",
    sigma: float = 0.02,
) -> torch.Tensor:
    """Drop-in for ops.histogram.calculate_rgbuv_histogram: [-1, 1] NHWC in,
    (B, size, size, 3) normalized to sum 1 per image out."""
    return hk.fused_histogram(image_batch, size, method, sigma, torch.float32, ("K3a", "K4a"))
