"""The indexed variant's two losses in one kernel pair
(csrc/indexed_loss.cu): its ctypes wrapper, its plain PyTorch version, the
autograd function that joins the pair, and its launch count.

For int labels (..., ) and softmax logits (..., 256), `indexed_losses`
returns (seg, l1): `train/losses.py::sparse_categorical_crossentropy_logits`
and `::onehot_l1_logits`, each a mean over every position, labels of 256
and above keeping their meaning there (0 to the cross-entropy, 1 / C to the
L1).

The kernel pair replaces no TPU kernel: the JAX package leaves these losses
to XLA (palette_and_histo_gan_tpu/train/losses.py:108-146). It was added
because the float32 b1024 indexed step spent 65.6 ms a step in them on an
NVIDIA H100 80GB HBM3 (the forward, and the backward up to the logits'
gradient), at 5.9% of their bytes floor, in elementwise passes over the
4.29 GB of logits: two logsumexps forward, two logsumexp and two gather
backwards added together, the L1's even at lambda_l1 = 0. The work is bound
by bytes: the forward reads the logits once, the backward reads them once
and writes their gradient once.

`indexed_losses` sends CUDA logits to the kernels (they launch or raise, with
no fallback) and CPU logits to the plain version, which is the two functions
of train/losses.py as they are, bit for bit. The kernels take float32 or
bfloat16 logits (upcast in registers; the gradient comes back in the logits'
dtype and strides) laid out as the generator's (B, H, W, 256) view of its
NCHW head output, which is what the card's convolution gives: the pixels of
a class next to each other, the classes a fixed distance apart (`layout`).
Anything else raises, channels-last logits included; the logits are never
copied. The forward sums in a fixed order without atomics, so a relaunch
gives the same bits.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from ..kernels import build

CLASSES = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches in this process, one a call of each kernel entry (the forward's
# entry launches the row pass and the mean). Only a launch that returned no
# error counts; callers that want to count a run set it to 0 first
# (reset_launches).
launches = {"CCE-fwd": 0, "CCE-bwd": 0}

_lib = None


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def library() -> ctypes.CDLL:
    """The kernels' shared library, built from csrc/indexed_loss.cu at first use."""
    global _lib
    if _lib is None:
        lib = build.load_library("phg_indexed_loss", ("indexed_loss.cu",))
        i64, f32, ptr, i32 = ctypes.c_int64, ctypes.c_float, ctypes.c_void_p, ctypes.c_int
        # images, pixels, image_stride, class_stride
        lib.phg_cce_partials.argtypes = [i64] * 4
        lib.phg_cce_partials.restype = i64
        # logits, dtype, the layout, labels, lo, hi, stats, partials, seg, l1; stream
        lib.phg_cce_forward.argtypes = [ptr, i32] + [i64] * 4 + [ptr, f32, f32] + [ptr] * 5
        lib.phg_cce_forward.restype = i32
        # logits, dtype, the layout, labels, stats, g_seg, g_l1, lo, hi, grad; stream
        lib.phg_cce_backward.argtypes = [ptr, i32] + [i64] * 4 + [ptr] * 4 + [f32, f32, ptr, ptr]
        lib.phg_cce_backward.restype = i32
        _lib = lib
    return _lib


def layout(x: torch.Tensor) -> tuple[int, int, int, int]:
    """(images, pixels, image_stride, class_stride) of a (..., 256) tensor the
    kernels take, strides in elements: the dimensions before the classes
    merge into pixels (innermost, stride 1) and images (one stride), the
    classes a fixed distance apart, as in the generator's view of its NCHW
    head output. Raises on anything else."""
    if x.dim() < 2 or x.shape[-1] != CLASSES:
        raise ValueError(f"logits must be (..., {CLASSES}), got {tuple(x.shape)}")
    groups = []  # [size, stride] of the merged dimensions, innermost first
    for size, step in zip(reversed(x.shape[:-1]), reversed(x.stride()[:-1])):
        if size == 1:
            continue
        if groups and step == groups[-1][0] * groups[-1][1]:
            groups[-1][0] *= size
        else:
            groups.append([size, step])
    if len(groups) > 2:
        raise ValueError(f"logits' pixels merge into no (images, pixels): strides {x.stride()}")
    class_stride = x.stride(-1)
    if not groups:
        groups.append([1, 1])
    (pixels, pixel_stride), (images, image_stride) = (groups + [[1, 0]])[:2]
    if pixel_stride != 1 or class_stride == 1:
        raise ValueError(f"logits need the pixels of a class next to each other (NCHW memory), "
                         f"got strides {x.stride()}")
    if class_stride < pixels or (images > 1 and image_stride < CLASSES * class_stride):
        raise ValueError(f"logits' classes overlap: strides {x.stride()}")
    if pixels % 4 or class_stride % 4 or image_stride % 4:
        raise ValueError(f"logits need pixels and strides in 4s: {tuple(x.shape)}, "
                         f"strides {x.stride()}")
    return images, pixels, image_stride, class_stride


def check(labels: torch.Tensor, logits: torch.Tensor) -> tuple[int, int, int, int]:
    """The logits' layout when the kernels take these tensors; raises on
    anything else."""
    if logits.dtype not in DTYPES:
        raise ValueError(f"logits must be float32 or bfloat16, got {logits.dtype}")
    if logits.numel() == 0:
        raise ValueError(f"logits are empty: {tuple(logits.shape)}")
    dims = layout(logits)
    if labels.shape != logits.shape[:-1]:
        raise ValueError(f"labels {tuple(labels.shape)} do not match logits {tuple(logits.shape)}")
    if labels.dtype.is_floating_point or labels.dtype.is_complex or labels.dtype == torch.bool:
        raise ValueError(f"labels must be integers, got {labels.dtype}")
    if labels.device != logits.device:
        raise ValueError(f"labels on {labels.device}, logits on {logits.device}")
    return dims


def indexed_losses_plain(labels: torch.Tensor, logits: torch.Tensor):
    """(seg, l1) by the two functions of train/losses.py, in the order the
    train step took them before the kernels (the L1 first)."""
    # train/steps.py imports this module, so the losses come in at the call
    from ..train import losses

    l1 = losses.onehot_l1_logits(labels, logits)
    seg = losses.sparse_categorical_crossentropy_logits(labels, logits)
    return seg, l1


def _bounds() -> tuple[float, float]:
    from ..train import losses

    return losses.NEG_LOG_MIN, losses.NEG_LOG_MAX


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch_checks(labels, logits, what: str):
    """The layout and the labels as the kernels read them (int32, in row
    order; a copy only where they are not already); raises on anything the
    kernels do not take."""
    dims = check(labels, logits)
    if logits.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {logits.device}")
    lib = library()
    align = 4 * logits.element_size()
    if logits.data_ptr() % align:
        raise ValueError(f"logits must start on a {align}-byte boundary")
    return lib, dims, labels.reshape(-1).to(torch.int32).contiguous()


def forward_cuda(labels: torch.Tensor, logits: torch.Tensor):
    """Launch the forward pair on CUDA tensors: (seg, l1, stats), the first
    two 0-dim float32, stats each row's float32 (lse, z_t), (N, 2). Raises
    on anything the kernels do not take and on a failed launch."""
    lib, dims, rows = _launch_checks(labels, logits, "forward_cuda")
    device = logits.device
    stats = torch.empty((rows.numel(), 2), dtype=torch.float32, device=device)
    partials = torch.empty((lib.phg_cce_partials(*dims), 2), dtype=torch.float64, device=device)
    seg = torch.empty((), dtype=torch.float32, device=device)
    l1 = torch.empty_like(seg)
    with torch.cuda.device(device):
        rc = lib.phg_cce_forward(
            logits.data_ptr(), DTYPES[logits.dtype], *dims, rows.data_ptr(), *_bounds(),
            stats.data_ptr(), partials.data_ptr(), seg.data_ptr(), l1.data_ptr(), _stream(logits),
        )
    if rc != 0:
        raise RuntimeError(f"indexed loss forward launch failed: cudaError {rc}")
    launches["CCE-fwd"] += 1
    return seg, l1, stats


def backward_cuda(labels: torch.Tensor, logits: torch.Tensor, stats: torch.Tensor,
                  g_seg: torch.Tensor, g_l1: torch.Tensor) -> torch.Tensor:
    """Launch the backward kernel: the gradient of g_seg * seg + g_l1 * l1
    with respect to the logits, in their dtype and strides. The upstream
    gradients stay on the device (no host sync)."""
    lib, dims, rows = _launch_checks(labels, logits, "backward_cuda")
    if stats.shape != (rows.numel(), 2) or stats.dtype != torch.float32 or not stats.is_contiguous():
        raise ValueError(f"stats must be forward_cuda's float32 ({rows.numel()}, 2)")
    grad = torch.empty_strided(logits.shape, logits.stride(), dtype=logits.dtype, device=logits.device)
    g_seg, g_l1 = (g.to(torch.float32).contiguous() for g in (g_seg, g_l1))
    with torch.cuda.device(logits.device):
        rc = lib.phg_cce_backward(
            logits.data_ptr(), DTYPES[logits.dtype], *dims, rows.data_ptr(), stats.data_ptr(),
            g_seg.data_ptr(), g_l1.data_ptr(), *_bounds(), grad.data_ptr(), _stream(logits),
        )
    if rc != 0:
        raise RuntimeError(f"indexed loss backward launch failed: cudaError {rc}")
    launches["CCE-bwd"] += 1
    return grad


class IndexedLosses(torch.autograd.Function):
    """(labels, logits) -> (seg, l1) by the forward pair; the backward
    kernel writes the logits' gradient once."""

    @staticmethod
    def forward(ctx, labels, logits):
        seg, l1, stats = forward_cuda(labels, logits)
        ctx.save_for_backward(labels, logits, stats)
        return seg, l1

    @staticmethod
    @once_differentiable
    def backward(ctx, g_seg, g_l1):
        labels, logits, stats = ctx.saved_tensors
        return None, backward_cuda(labels, logits, stats, g_seg, g_l1)


def indexed_losses(labels: torch.Tensor, logits: torch.Tensor):
    """(seg, l1), each a 0-dim float32 mean: the kernels for CUDA logits,
    the plain version for CPU logits; any other device raises."""
    if logits.device.type == "cuda":
        return IndexedLosses.apply(labels, logits)
    if logits.device.type != "cpu":
        raise ValueError(f"indexed_losses runs on CUDA or CPU tensors, got {logits.device}")
    return indexed_losses_plain(labels, logits)
