"""An H100 SXM's published peaks (NVIDIA's data sheet, dense, at the full
700 W power limit): a frozen copy of palette_and_histo_gan_tpu_torch/
utils/roofline.py::PEAK and `bound`. Memory in bytes/s, operations/s by
type; bfloat16 and tf32 are the tensor cores' rates, float32 the CUDA
cores' (float32 runs with TF32 off)."""

from __future__ import annotations

PEAK = {"bytes": 3.35e12, "float32": 67e12, "bfloat16": 989e12, "tf32": 495e12}


def bound_seconds(nbytes: float, *ops: tuple[float, str]) -> float:
    """The least time the card could take for some work: its bytes over the
    memory rate or the slowest of its (count, type) operation terms over
    that type's peak, whichever is larger."""
    t_ops = max((n / PEAK[kind] for n, kind in ops), default=0.0)
    return max(nbytes / PEAK["bytes"], t_ops)
