"""Kernel K6, the InstanceNorm moments (csrc/moments.cu): its ctypes wrapper,
its plain PyTorch version and its launch count.

The kernel replaces the TPU kernel `scripts/bench_in_stats.py::
_moments_kernel`, reached by `stats_pallas`: for each (sample, channel)
row of a (B, C, H, W) tensor, in one pass over it,

    mean  = sum(x)     * float32(1 / HW)
    mean2 = sum(x * x) * float32(1 / HW)

with x upcast to float32 before the square (the networks' bfloat16
InstanceNorm, `models/networks.py`, squares in bfloat16 first, so its
mean2 differs from this one by up to about a bfloat16 rounding of each
square; this module keeps the TPU kernel's function). Both outputs are
(B, C) float32, and every row is written whatever B is (the TPU kernel's
grid of B // 8 blocks leaves the rows past the last whole block of 8
unwritten).

Inputs: bfloat16 or float32 (B, C, H, W), either contiguous (NCHW, the
layout the port's networks hold) or `channels_last` (NHWC in memory, the
TPU kernel's own layout); any other layout or dtype, or an empty tensor,
raises.

`moments` sends CUDA tensors to the kernel (it launches or raises) and
CPU tensors to the plain version, which sums each row in float64 and
rounds once to float32, as the plain histogram forward does
(`ops/histogram_kernel.py::_forward_product`); the kernel sums in float32
in its own fixed order.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LAYOUTS = {"nchw": 0, "nhwc": 1}

# launches in this process. Only a launch that returned no error counts;
# callers that want to count a run set it to 0 first (reset_launches).
launches = {"K6": 0}

_lib = None


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def library() -> ctypes.CDLL:
    """The kernel's shared library, built from csrc/moments.cu at first use."""
    global _lib
    if _lib is None:
        lib = build.load_library("phg_moments", ("moments.cu",))
        # x, mean, mean2; dtype, layout, b, c, hw; stream
        lib.phg_moments.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.phg_moments.restype = ctypes.c_int
        _lib = lib
    return _lib


def layout(x: torch.Tensor) -> str:
    """"nchw" or "nhwc" for a bfloat16 or float32 (B, C, H, W) tensor the
    kernel takes; raises on anything else. A tensor that is both (C == 1 or
    H * W == 1: the two orders are the same bytes) counts as NCHW."""
    if x.dtype not in DTYPES or x.dim() != 4:
        raise ValueError(f"x must be bfloat16 or float32 (B, C, H, W), got {x.dtype} {tuple(x.shape)}")
    if x.numel() == 0:
        raise ValueError(f"x is empty: {tuple(x.shape)}")
    if x.is_contiguous():
        return "nchw"
    if x.is_contiguous(memory_format=torch.channels_last):
        return "nhwc"
    raise ValueError(f"x must be contiguous or channels_last, got strides {x.stride()}")


def moments_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in PyTorch: x upcast to float32 and squared
    there, each row's sums taken in float64 and rounded to float32, then
    multiplied by float32(1 / HW) as the TPU kernel does (for an HW that is
    not a power of two, a division would differ in the last place)."""
    layout(x)
    b, c, h, w = x.shape
    x32 = x.float()
    inv = torch.tensor(1.0 / (h * w), dtype=torch.float32, device=x.device)
    s = x32.sum((2, 3), dtype=torch.float64).float()
    s2 = (x32 * x32).sum((2, 3), dtype=torch.float64).float()
    return s * inv, s2 * inv


def moments_cuda(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K6 on a CUDA tensor; raises on anything the kernel does not
    take and on a failed launch."""
    order = layout(x)
    if x.device.type != "cuda":
        raise ValueError(f"moments_cuda needs a CUDA tensor, got {x.device}")
    b, c, h, w = x.shape
    if x.numel() >= 2**31:
        raise ValueError(f"x has {x.numel()} elements; the kernel takes fewer than 2^31")
    mean = torch.empty((b, c), dtype=torch.float32, device=x.device)
    mean2 = torch.empty_like(mean)
    lib = library()
    with torch.cuda.device(x.device):
        rc = lib.phg_moments(
            x.data_ptr(), mean.data_ptr(), mean2.data_ptr(), DTYPES[x.dtype], LAYOUTS[order],
            b, c, h * w, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"moments kernel launch failed: cudaError {rc}")
    launches["K6"] += 1
    return mean, mean2


def moments(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, C, H, W) bfloat16 or float32 -> (mean, mean2), each (B, C)
    float32: the kernel for a CUDA tensor, the plain version for a CPU
    tensor; any other device raises."""
    if x.device.type == "cuda":
        return moments_cuda(x)
    if x.device.type != "cpu":
        raise ValueError(f"moments runs on a CUDA or a CPU tensor, got {x.device}")
    return moments_plain(x)
