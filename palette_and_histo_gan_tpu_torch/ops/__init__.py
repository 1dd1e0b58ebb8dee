"""Tensor ops: image transforms, the fused augmentation (CUDA kernel and its
plain version), the differentiable RGB-uv color histogram (plain
PyTorch, and the fused histogram kernels with their plain versions) and
the palette ops of the indexed variant (palette indexing: CUDA kernel and
its plain version)."""

from . import (
    augment,
    augment_kernel,
    histogram,
    histogram_kernel,
    histogram_pallas,
    histogram_pallas2,
    histogram_pallas3,
    image,
    palette,
    palette_kernel,
    palette_pallas,
)

__all__ = [
    "augment",
    "augment_kernel",
    "histogram",
    "histogram_kernel",
    "histogram_pallas",
    "histogram_pallas2",
    "histogram_pallas3",
    "image",
    "palette",
    "palette_kernel",
    "palette_pallas",
]
