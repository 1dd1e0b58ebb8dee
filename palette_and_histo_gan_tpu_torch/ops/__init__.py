"""Tensor ops: image transforms, the fused augmentation (CUDA kernel and its
plain version) and the differentiable RGB-uv color histogram (plain
PyTorch, and the fused histogram kernels with their plain versions)."""

from . import (
    augment,
    augment_kernel,
    histogram,
    histogram_kernel,
    histogram_pallas,
    histogram_pallas2,
    histogram_pallas3,
    image,
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
]
