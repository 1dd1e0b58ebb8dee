"""Paired augmentation of RGBA sprite batches: the draws and the plain
PyTorch version of the fused kernel.

Mirrors `palette_and_histo_gan_tpu/ops/augment.py` and
`ops/augment_pallas.py`: with probability `prob` a pair of images gets one
shared hue rotation (RGB only, alpha passes through) and one shared integer
translation with zero fill; otherwise it passes unchanged. The hue algebra
is the TPU kernel's (`augment_pallas.py::_hue_rotate_planar`): one
reciprocal, saturation never formed, hue kept in the [0, 6) sextant domain.

`augment_batch_sharded` draws for the global batch and augments this
rank's rows of it (all of them in one process). `augment_with_draws` takes the draws as
tensors and sends CUDA tensors to the CUDA kernel (`ops/augment_kernel.py`), CPU tensors to `augment_plain`.
A CUDA batch never reaches the plain version.
"""

from __future__ import annotations

import torch

from . import augment_kernel

# keras RandomTranslation factors and the hue range of the reference
# pipeline, as declared in palette_and_histo_gan_tpu/ops/augment.py:27-29
HEIGHT_FACTOR = (-0.15, 0.075)
WIDTH_FACTOR = (-0.125, 0.125)
MAX_HUE_DELTA = 0.5

SIDE = 64


def draw_params(generator: torch.Generator, b: int, prob: float):
    """Per-pair draws on the generator's device, with the distributions of
    augment_pallas.py::_draw_params: delta ~ U(-0.5, 0.5) turns,
    (sy, sx) = round(U(HEIGHT_FACTOR) * 64, U(WIDTH_FACTOR) * 64) half to
    even, keep = U(0, 1) < prob. Returns (delta f32, sy, sx, keep int32),
    each of shape (b,)."""
    u = torch.rand((4, b), generator=generator, device=generator.device)
    choice, u_hue, u_dy, u_dx = u
    delta = -MAX_HUE_DELTA + u_hue * (2 * MAX_HUE_DELTA)
    dy = (HEIGHT_FACTOR[0] + u_dy * (HEIGHT_FACTOR[1] - HEIGHT_FACTOR[0])) * SIDE
    dx = (WIDTH_FACTOR[0] + u_dx * (WIDTH_FACTOR[1] - WIDTH_FACTOR[0])) * SIDE
    sy = torch.round(dy).to(torch.int32)
    sx = torch.round(dx).to(torch.int32)
    keep = (choice < prob).to(torch.int32)
    return delta.contiguous(), sy, sx, keep


def _floor_mod6(x: torch.Tensor) -> torch.Tensor:
    """jnp's float `%`: C fmod, plus the divisor where the signs differ."""
    r = torch.fmod(x, 6.0)
    return torch.where(r < 0, r + 6.0, r)


def hue_sextant(r, g, b):
    """(h, vmax, mn, rng) of the TF HSV convention with the hue h in
    [0, 6) sextants (h / 6 is TF's hue)."""
    vmax = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    rng = vmax - mn
    inv_rng = 1.0 / torch.where(rng == 0, torch.ones_like(rng), rng)
    hr = _floor_mod6((g - b) * inv_rng)
    hg = (b - r) * inv_rng + 2.0
    hb = (r - g) * inv_rng + 4.0
    h = torch.where(vmax == r, hr, torch.where(vmax == g, hg, hb))
    h = torch.where(rng == 0, torch.zeros_like(h), h)
    return h, vmax, mn, rng


def hue_rotate(r, g, b, delta):
    """Rotate the hue of (r, g, b) by `delta` turns (tf.image.adjust_hue on
    any non-negative scale); returns the new (r, g, b)."""
    h, _, mn, rng = hue_sextant(r, g, b)
    dh = _floor_mod6(h + 6.0 * delta)
    dr = torch.clamp(torch.abs(dh - 3.0) - 1.0, 0.0, 1.0)
    dg = torch.clamp(2.0 - torch.abs(dh - 2.0), 0.0, 1.0)
    db = torch.clamp(2.0 - torch.abs(dh - 4.0), 0.0, 1.0)
    return mn + rng * dr, mn + rng * dg, mn + rng * db


def shift_images(img: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """out[i, y, x] = img[i, y - sy[i], x - sx[i]], zero outside: the
    nearest-neighbour integer translation of translate_nearest, on a
    (B, H, W, C) batch."""
    b, h, w, _ = img.shape
    dev = img.device
    ys = torch.arange(h, device=dev)[None, :] - sy[:, None].long()  # (B, H)
    xs = torch.arange(w, device=dev)[None, :] - sx[:, None].long()  # (B, W)
    inside = (((ys >= 0) & (ys < h))[:, :, None] & ((xs >= 0) & (xs < w))[:, None, :])
    rows = torch.arange(b, device=dev)[:, None, None]
    gathered = img[rows, ys.clamp(0, h - 1)[:, :, None], xs.clamp(0, w - 1)[:, None, :]]
    return torch.where(inside[..., None], gathered, torch.zeros_like(gathered))


def to_float_rgba(x: torch.Tensor) -> torch.Tensor:
    """Any kernel input format (see ops/augment_kernel.py) as float32
    (B, 64, 64, 4) on the [0, 255] scale."""
    fmt = augment_kernel.input_format(x)
    if fmt == augment_kernel.FMT_PACKED:
        # little-endian bytes of each pixel word are R, G, B, A
        x = x.contiguous().view(torch.uint8).reshape(x.shape[0], SIDE, SIDE, 4)
    return x.to(torch.float32)


def augment_plain(
    src, tgt, delta, sy, sx, keep, *, normalize_out=False, out_dtype=torch.float32
):
    """The fused kernel's function in plain PyTorch, on the same draws:
    hue rotation, then translation, then the keep-select, then the optional
    [0, 255] -> [-1, 1] normalize and one cast to `out_dtype`."""
    kept = (keep != 0)[:, None, None, None]
    outs = []
    for img in (src, tgt):
        v = to_float_rgba(img)
        r, g, b = hue_rotate(v[..., 0], v[..., 1], v[..., 2], delta[:, None, None])
        rotated = torch.stack([r, g, b, v[..., 3]], dim=-1)
        out = torch.where(kept, shift_images(rotated, sy, sx), v)
        if normalize_out:
            out = out / 127.5 - 1.0
        outs.append(out.to(out_dtype))
    return outs[0], outs[1]


def augment_with_draws(
    src, tgt, delta, sy, sx, keep, *, normalize_out=False, out_dtype=torch.float32
):
    """The augmentation on explicit draws: the CUDA kernel for CUDA tensors
    (it launches or raises), the plain version for CPU tensors."""
    kw = dict(normalize_out=normalize_out, out_dtype=out_dtype)
    if src.is_cuda:
        return augment_kernel.augment_cuda(src, tgt, delta, sy, sx, keep, **kw)
    if src.device.type != "cpu":
        raise ValueError(f"no augmentation for tensors on {src.device}")
    return augment_plain(src, tgt, delta, sy, sx, keep, **kw)


def augment_batch_sharded(
    src, tgt, generator: torch.Generator, prob: float = 0.8, *, global_batch: int,
    first_row: int = 0, normalize_out=False, out_dtype=torch.float32,
):
    """Draw from `generator` (on the batch's device) for a batch of
    `global_batch` pairs and augment its rows `first_row` onward, as many
    as `src` has: augment_pallas.py::augment_batch_pallas(_packed)'s
    counterpart when they are the whole batch (`global_batch` = len(src)),
    and augment_batch_pallas_sharded's on a data-parallel rank's rows. The
    generator advances as one process's, and the augmentation is per pair,
    so a rank's rows equal one process's."""
    rows = slice(first_row, first_row + src.shape[0])
    draws = [d[rows] for d in draw_params(generator, global_batch, prob)]
    return augment_with_draws(
        src, tgt, *draws, normalize_out=normalize_out, out_dtype=out_dtype
    )
