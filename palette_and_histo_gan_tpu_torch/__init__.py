"""palette_and_histo_gan_tpu_torch: the PyTorch and CUDA port of
palette_and_histo_gan_tpu for NVIDIA Hopper GPUs (H100, sm_90a).

It trains the four pix2pix sprite-translation GANs of the JAX package
(baseline-no-aug, baseline, histogram, indexed) with a configuration of the
same fields (`config.py`, the port's own copy), in PyTorch's own idiom:
`nn.Module`s, an explicit `device` and explicit `torch.Generator`s. The TPU
kernels are CUDA kernels written by hand (`csrc/`), each with a plain
PyTorch version that serves CPU tensors. This package imports neither JAX
nor anything of the JAX package.
"""

from .config import (
    DIRECTIONS,
    MODEL_VARIANTS,
    PALETTE_ORDERINGS,
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
    "PALETTE_ORDERINGS",
    "DIRECTIONS",
]
