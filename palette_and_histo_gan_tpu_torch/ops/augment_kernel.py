"""Wrapper of the fused augmentation CUDA kernel (csrc/augment.cu).

The kernel replaces the TPU kernels
`palette_and_histo_gan_tpu/ops/augment_pallas.py::_augment_kernel_packed`
and `::_augment_kernel`. Its plain PyTorch version is
`ops/augment.py::augment_plain`; `ops/augment.py::augment_with_draws`
sends CUDA tensors here and CPU tensors there.

Input formats, the same for source and target:
  * packed: int32 (B, 4096), each element the bit pattern of one
    little-endian RGBA pixel (byte 0 = R), as the train chunk's row gather
    produces it (`train/steps.py::pack_rows`);
  * uint8 (B, 64, 64, 4);
  * float32 (B, 64, 64, 4) on the [0, 255] scale.
Output: two (B, 64, 64, 4) tensors of `out_dtype` (float32 or bfloat16).
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build

FMT_PACKED, FMT_U8, FMT_F32 = 0, 1, 2
PIXELS = 64 * 64

# launches in this process, by the TPU kernel each input layout stands in
# for: "packed" for _augment_kernel_packed (the train chunk's), "rgba"
# (uint8 or float32 pixels) for _augment_kernel (a single step on a uint8
# batch). Only a launch that returned no error counts; callers that want to
# count a run set both to 0 first (reset_launches).
launches = {"packed": 0, "rgba": 0}

_lib = None


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def library() -> ctypes.CDLL:
    """The kernel's shared library, built from csrc/augment.cu at first use."""
    global _lib
    if _lib is None:
        lib = build.load_library("phg_augment", ("augment.cu",), build.NO_FMA)
        lib.phg_augment.argtypes = (
            # fmt, out_bf16, normalize; src, tgt, delta, sy, sx, keep, out_s,
            # out_t; batch; stream
            [ctypes.c_int] * 3 + [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p]
        )
        lib.phg_augment.restype = ctypes.c_int
        _lib = lib
    return _lib


def input_format(x: torch.Tensor) -> int:
    """The kernel's format code for a source/target tensor; raises on a
    dtype or shape it does not take."""
    if x.dtype == torch.int32 and tuple(x.shape[1:]) == (PIXELS,):
        return FMT_PACKED
    if x.dtype in (torch.uint8, torch.float32) and tuple(x.shape[1:]) == (64, 64, 4):
        return FMT_U8 if x.dtype == torch.uint8 else FMT_F32
    raise ValueError(
        f"augment kernel takes packed int32 (B, 4096), uint8 or float32 "
        f"(B, 64, 64, 4); got {x.dtype} {tuple(x.shape)}"
    )


def augment_cuda(
    src: torch.Tensor,
    tgt: torch.Tensor,
    delta: torch.Tensor,
    sy: torch.Tensor,
    sx: torch.Tensor,
    keep: torch.Tensor,
    *,
    normalize_out: bool = False,
    out_dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the fused augmentation on CUDA tensors; raises on anything the
    kernel does not take and on a failed launch."""
    fmt = input_format(src)
    b = src.shape[0]
    device = src.device
    if device.type != "cuda":
        raise ValueError(f"augment_cuda needs CUDA tensors, got {device}")
    if tgt.dtype != src.dtype or tgt.shape != src.shape or tgt.device != device:
        raise ValueError(
            f"source {src.dtype} {tuple(src.shape)} {src.device} and target "
            f"{tgt.dtype} {tuple(tgt.shape)} {tgt.device} must match"
        )
    for name, t, dtype in (
        ("delta", delta, torch.float32), ("sy", sy, torch.int32),
        ("sx", sx, torch.int32), ("keep", keep, torch.int32),
    ):
        if t.dtype != dtype or tuple(t.shape) != (b,) or t.device != device:
            raise ValueError(
                f"{name} must be {dtype} ({b},) on {device}; got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    ins = (src, tgt, delta, sy, sx, keep)
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("augment_cuda needs contiguous inputs")
    if fmt == FMT_F32 and (src.data_ptr() % 16 or tgt.data_ptr() % 16):
        raise ValueError("float32 inputs must be 16-byte aligned (one float4 a pixel)")

    out_s = torch.empty((b, 64, 64, 4), dtype=out_dtype, device=device)
    out_t = torch.empty_like(out_s)
    lib = library()
    with torch.cuda.device(device):
        rc = lib.phg_augment(
            fmt,
            int(out_dtype == torch.bfloat16),
            int(normalize_out),
            *(t.data_ptr() for t in ins),
            out_s.data_ptr(),
            out_t.data_ptr(),
            b,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"augment kernel launch failed: cudaError {rc}")
    launches["packed" if fmt == FMT_PACKED else "rgba"] += 1
    return out_s, out_t
