"""The fused histogram, v2: `histogram_impl="pallas2"`.

Counterpart of palette_and_histo_gan_tpu/ops/histogram_pallas2.py: the
forward is kernel K3b and the backward kernel K4b (ops/histogram_kernel.py,
csrc/histogram.cu), the chain in `dtype` (bfloat16 in bfloat16 mode) with
float32 accumulation, the logs and Iy computed in float32 outside the
kernels.
"""

from __future__ import annotations

import torch

from . import histogram_kernel as hk


def calculate_rgbuv_histogram_pallas2(
    image_batch: torch.Tensor,
    size: int = 64,
    method: str = "inverse-quadratic",
    sigma: float = 0.02,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Drop-in for ops.histogram.calculate_rgbuv_histogram: [-1, 1] NHWC in,
    (B, size, size, 3) normalized to sum 1 per image out."""
    return hk.fused_histogram(image_batch, size, method, sigma, dtype, ("K3b", "K4b"))
