"""Tensor ops: image transforms, the fused augmentation (CUDA kernel and its
plain version) and the differentiable RGB-uv color histogram."""

from . import augment, augment_kernel, histogram, image

__all__ = ["augment", "augment_kernel", "histogram", "image"]
