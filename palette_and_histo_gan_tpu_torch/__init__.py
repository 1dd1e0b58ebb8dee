"""palette_and_histo_gan_tpu_torch: the PyTorch and CUDA port of
palette_and_histo_gan_tpu for NVIDIA Hopper GPUs (H100, sm_90a).

It trains the pix2pix sprite-translation GANs of the JAX package with the
same configuration (`palette_and_histo_gan_tpu.config`, which imports only
the standard library), in PyTorch's own idiom: `nn.Module`s, an explicit
`device` and explicit `torch.Generator`s. The TPU kernels on its path are
CUDA kernels written by hand (`csrc/`), each with a plain PyTorch version
that serves CPU tensors. This package imports no JAX.
"""

from .config import (
    DIRECTIONS,
    MODEL_VARIANTS,
    Config,
    check_supported,
    config_for_variant,
    set_f32_parity_mode,
)

__version__ = "0.1.0"

__all__ = [
    "Config",
    "config_for_variant",
    "check_supported",
    "set_f32_parity_mode",
    "MODEL_VARIANTS",
    "DIRECTIONS",
]
