"""Configuration: the JAX package's `Config`, and what the port accepts.

`palette_and_histo_gan_tpu.config` (and that package's `__init__`) import
only the standard library, so both packages are driven by one frozen
dataclass and the parity tests hand the same `Config` to each.

The histogram knobs mean what they mean in the JAX step:
`histogram_impl` "xla" (plain PyTorch forward), "pallas" (kernels K3a/K4a,
float32 chain) or "pallas2" (kernels K3b/K4b, chain in the compute dtype);
under "xla" only, `histogram_bwd` "tri" (plain PyTorch) or "pallas"
(kernel K4c). The JAX step ignores `histogram_bwd` under "pallas" and
"pallas2", and so does the port.

Knobs the port does not implement raise `NotImplementedError` in
`check_supported` (see ROADMAP.md, "Queue 1"):
  * `histogram_bwd` "dual", "tri2", "tri2b", "tri2c" under
    `histogram_impl="xla"`: XLA dot-structure alternatives of the "tri"
    backward, measured on the TPU and not ported;
  * the indexed model.

Knobs that only choose a TPU lowering of the same function, and that the
port ignores: `transpose_impl`, `head_conv`, `infer_head_conv`,
`d_input_split`, `dropout_prng`, `xla_compiler_options`, `donate_state`,
`data_parallel`, `data_axis`. `augment_impl` "xla" asks for the plain
augmentation, which the port runs only on CPU tensors; a CUDA batch always
goes through the kernel, and `check_supported` rejects "xla" for a CUDA
device.
"""

from __future__ import annotations

import torch

from palette_and_histo_gan_tpu.config import (  # noqa: F401  (re-exported)
    DIRECTIONS,
    MODEL_VARIANTS,
    Config,
    config_for_variant,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the histogram backwards the port runs under histogram_impl="xla"
HISTOGRAM_BWDS = ("tri", "pallas")


def check_supported(config: Config, device: torch.device | str) -> None:
    """Raise NotImplementedError for a configuration the port cannot run."""
    device = torch.device(device)
    if config.is_indexed:
        raise NotImplementedError(
            "the indexed model is not ported yet (ROADMAP.md, Queue 1: "
            "indexed slice, with kernel K5)"
        )
    if config.histogram_impl == "xla" and config.histogram_bwd not in HISTOGRAM_BWDS:
        raise NotImplementedError(
            f"histogram_bwd={config.histogram_bwd!r}: an XLA dot-structure "
            f"alternative the port does not run; it has {HISTOGRAM_BWDS}"
        )
    if device.type == "cuda" and config.augment_impl == "xla":
        raise ValueError(
            "augment_impl='xla' asks for the plain augmentation, which serves "
            "CPU tensors only; on a CUDA device the port runs the kernel "
            "(use 'auto' or 'pallas')"
        )


def compute_dtype(config: Config) -> torch.dtype:
    return DTYPES[config.compute_dtype]


def set_f32_parity_mode() -> None:
    """Pin float32 products to full float32: TF32 off for cuDNN
    convolutions and for cuBLAS matmuls (PyTorch's cuDNN default is TF32,
    about three decimal digits)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
