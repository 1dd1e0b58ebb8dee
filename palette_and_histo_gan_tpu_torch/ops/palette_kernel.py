"""Kernel K5, palette indexing (csrc/palette.cu): its ctypes wrapper, its
plain PyTorch version and its launch count.

The kernel replaces the TPU kernel
`palette_and_histo_gan_tpu/ops/palette_pallas.py::_index_kernel`: for each
pixel, the sum of the indices of the 256 palette slots equal to its RGBA
colour. A pixel that matches nothing gets 0; a pixel equal to the hotpink
filler matches every filler slot and gets a sum past 255, as the
reference's scatter-sum does.

Inputs: uint8 (N, H, W, 4) images and int32 (N, 256, 4) palettes with
values in [0, 255]; image i is indexed with palette i, so the sources and
the targets of a split are indexed in two calls against the same
palettes. Output: int32 (N, H, W, 1).

`rgba_to_indexed` sends CUDA tensors to the kernel (it launches or raises)
and CPU tensors to the plain version. Both compare each pixel's 4 bytes
read as one little-endian 32-bit word (byte 0 = R, as
`train/steps.py::pack_rows` views them) with each palette slot packed in
the same byte order.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build

PALETTE_SLOTS = 256
# images per pass of the plain version, which holds an (images, HW, 256)
# comparison
PLAIN_CHUNK = 32

# launches in this process. Only a launch that returned no error counts;
# callers that want to count a run set it to 0 first (reset_launches).
launches = {"K5": 0}

_lib = None


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def library() -> ctypes.CDLL:
    """The kernel's shared library, built from csrc/palette.cu at first use."""
    global _lib
    if _lib is None:
        lib = build.load_library("phg_palette", ("palette.cu",))
        # images, palettes, out; n_images, pixels; stream
        lib.phg_palette_index.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        lib.phg_palette_index.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(images: torch.Tensor, palettes: torch.Tensor) -> None:
    if images.dtype != torch.uint8 or images.dim() != 4 or images.shape[-1] != 4:
        raise ValueError(f"images must be uint8 (N, H, W, 4), got {images.dtype} {tuple(images.shape)}")
    n = images.shape[0]
    if palettes.dtype != torch.int32 or tuple(palettes.shape) != (n, PALETTE_SLOTS, 4):
        raise ValueError(
            f"palettes must be int32 ({n}, {PALETTE_SLOTS}, 4), got "
            f"{palettes.dtype} {tuple(palettes.shape)}"
        )
    if palettes.device != images.device:
        raise ValueError(f"images on {images.device}, palettes on {palettes.device}")
    if not (images.is_contiguous() and palettes.is_contiguous()):
        raise ValueError("images and palettes must be contiguous")


def _pack_le(rgba: torch.Tensor) -> torch.Tensor:
    """(..., 4) uint8 -> (...,) int32 whose bits are the 4 bytes in memory
    order (little-endian: R is the low byte)."""
    return rgba.contiguous().view(torch.int32)[..., 0]


def rgba_to_indexed_plain(images: torch.Tensor, palettes: torch.Tensor) -> torch.Tensor:
    """The kernel's function in PyTorch, a chunk of images at a time."""
    _check(images, palettes)
    n, h, w, _ = images.shape
    px = _pack_le(images.reshape(n, h * w, 4))  # (N, HW)
    pal = _pack_le(palettes.to(torch.uint8))  # (N, 256)
    slots = torch.arange(PALETTE_SLOTS, dtype=torch.int32, device=images.device)
    out = torch.empty((n, h * w), dtype=torch.int32, device=images.device)
    for i in range(0, n, PLAIN_CHUNK):
        eq = px[i:i + PLAIN_CHUNK, :, None] == pal[i:i + PLAIN_CHUNK, None, :]
        out[i:i + PLAIN_CHUNK] = torch.where(eq, slots, 0).sum(-1, dtype=torch.int32)
    return out.reshape(n, h, w, 1)


def rgba_to_indexed_cuda(images: torch.Tensor, palettes: torch.Tensor) -> torch.Tensor:
    """Launch K5 on CUDA tensors; raises on anything the kernel does not
    take and on a failed launch."""
    _check(images, palettes)
    if images.device.type != "cuda":
        raise ValueError(f"rgba_to_indexed_cuda needs CUDA tensors, got {images.device}")
    if images.data_ptr() % 4:
        raise ValueError("images must be 4-byte aligned (one 32-bit word a pixel)")
    n, h, w, _ = images.shape
    out = torch.empty((n, h, w, 1), dtype=torch.int32, device=images.device)
    if n == 0 or h * w == 0:
        return out
    lib = library()
    with torch.cuda.device(images.device):
        rc = lib.phg_palette_index(
            images.data_ptr(), palettes.data_ptr(), out.data_ptr(), n, h * w,
            torch.cuda.current_stream(images.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"palette index kernel launch failed: cudaError {rc}")
    launches["K5"] += 1
    return out


def rgba_to_indexed(images: torch.Tensor, palettes: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 4) uint8 + (N, 256, 4) int32 -> (N, H, W, 1) int32: the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if images.device.type == "cuda":
        return rgba_to_indexed_cuda(images, palettes)
    return rgba_to_indexed_plain(images, palettes)
