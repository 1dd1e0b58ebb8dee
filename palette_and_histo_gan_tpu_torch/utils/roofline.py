"""The card's peaks and the least time a piece of work could take on it.

One source for `chip_smoke.py`'s kernels line, the roofline table
(`roofline.py`), the sweep's and the serving benchmark's MFU
(`sweep.py`, `bench_infer.py`): an H100 SXM's memory rate and its
operation rates by type (NVIDIA's data sheet, dense, at the full 700 W
power limit), and `bound`, the larger of a piece of work's bytes over the
memory rate and its operations over their type's peak.
"""

from __future__ import annotations

# An H100 SXM's peaks (NVIDIA's data sheet, dense): memory bytes/s and
# operations/s by type. int32 on the CUDA cores: 132 SMs x 64 INT32 lanes x
# 1.98 GHz (the Hopper white paper; half the float32 lanes behind the
# float32 67 TFLOP/s). bfloat16 and tf32 are the tensor cores' rates: the
# bfloat16 chain's products are bfloat16 x bfloat16 summed in float32, the
# float32 forward's three TF32 products a pair of factors (3xTF32).
PEAK = {"bytes": 3.35e12, "float32": 67e12, "bfloat16": 989e12, "tf32": 495e12,
        "int32": 132 * 64 * 1.98e9}
# the augmentation's float32 operations a pixel and image (hue rotation,
# select, normalize; csrc/augment.cu)
AUGMENT_OPS_PER_PIXEL = 40


def bound(nbytes: float, *ops: tuple[float, str]) -> tuple[float, str]:
    """The least time the card could take for this work, in ms, and what
    sets it: bytes over the memory rate, or the slowest of the (count,
    type) operation terms over their peak (each type on its own units)."""
    t_bytes = 1e3 * nbytes / PEAK["bytes"]
    t_ops = max(1e3 * n / PEAK[op_type] for n, op_type in ops)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def histogram_bound(w: dict, product_type: str | None = None) -> tuple[float, str]:
    """bound() of a histogram kernel's work (ops/histogram_kernel.py::work):
    its products, `passes` times, at the peak of `product_type` (default:
    the units the kernel takes them on), its elementwise chain at
    float32's, its bytes."""
    product_type = product_type or w["product_type"]
    passes = w["passes"] if product_type == w["product_type"] else 1
    return bound(w["bytes"], (passes * w["products"], product_type), (w["elementwise"], "float32"))


def augment_bound(batch: int, out_itemsize: int) -> tuple[float, str]:
    """bound() of one launch of the augmentation kernel on a packed batch
    of `batch` pairs of 64x64 RGBA images: both images' packed pixels and
    the draws read once (four draws a pair: hue delta, two shifts, the
    keep flag, four bytes each), both outputs written once in an
    `out_itemsize`-byte dtype, AUGMENT_OPS_PER_PIXEL float32 operations a
    pixel of each image."""
    moved = 2 * batch * 4096 * 4 + 4 * batch * 4 + 2 * batch * 4096 * 4 * out_itemsize
    return bound(moved, (AUGMENT_OPS_PER_PIXEL * 2 * batch * 4096, "float32"))


def mfu(flops_per_item: float, items_per_s: float, dtype: str, world: int = 1) -> float:
    """Model FLOP utilization: the FLOPs a second over the card's peak for
    the products' dtype (bfloat16 on the tensor cores; float32 runs with
    TF32 off, config.py::float32_exact), and over the cards of a
    data-parallel world, as the JAX sweep divides by its chips."""
    return flops_per_item * items_per_s / (world * PEAK[dtype])
