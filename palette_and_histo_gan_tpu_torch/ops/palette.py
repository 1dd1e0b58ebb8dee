"""Static-shape palette extraction and indexed-colour conversion.

Mirrors palette_and_histo_gan_tpu/ops/palette.py. Every function takes a
batch dimension written out (the JAX package vmaps single images), and
accepts a single image as well:

  extract_palettes:
    1. pack each RGBA pixel into one int64, r<<24 | g<<16 | b<<8 | a (int64
       because PyTorch sorts no uint32; the order of the packed values is
       the same);
    2. a stable sort of the packed values: equal colours become contiguous
       runs, each led by its first occurrence in the scan;
    3. run starts keep their first-occurrence index as an order key, the
       rest get the sentinel n;
    4. a second sort by that key yields the unique colours in order of
       first appearance in the leading slots of a fixed 256-slot palette,
       the rest filled with hotpink.

  The orderings: "top2bottom" and "bottom2top" (first appearance in the
  scan and in the reversed scan), "grayness" (a stable ascending sort by
  luma r*0.2989 + g*0.5870 + b*0.1140 in float32; colours that differ only
  in alpha tie and keep their appearance order) and "shuffled" (a random
  permutation of the valid colours, fillers last).

  Divergence from the JAX package: "shuffled" draws its permutation from a
  `torch.Generator` where the JAX package keys `jax.random` per pair, so
  the two packages shuffle differently; both keep the valid colours
  permuted and the fillers last.

  rgba_to_indexed: for each pixel the sum of the indices of the palette
  slots equal to it (kernel K5, ops/palette_kernel.py); indexed_to_rgba
  decodes a map, clamping the labels above 255 that sum makes to the last
  slot, as JAX's gather does.

A source/target pair shares one palette, extracted from the two images
concatenated on channels: the reshape to (-1, 4) then interleaves the two
images' pixels.
"""

from __future__ import annotations

import torch

from ..config import INVALID_INDEX_COLOR, MAX_PALETTE_SIZE
from . import palette_kernel

GRAY_COEFFS = (0.2989, 0.5870, 0.1140)  # the alpha coefficient is 0


def pack_rgba(colors: torch.Tensor) -> torch.Tensor:
    """(..., 4) integers in [0, 255] -> (...,) int64 r<<24 | g<<16 | b<<8 | a."""
    c = colors.to(torch.int64)
    return (c[..., 0] << 24) | (c[..., 1] << 16) | (c[..., 2] << 8) | c[..., 3]


def unpack_rgba(packed: torch.Tensor) -> torch.Tensor:
    """(...,) packed -> (..., 4) int32 RGBA."""
    p = packed.to(torch.int64)
    return torch.stack([(p >> 24) & 0xFF, (p >> 16) & 0xFF, (p >> 8) & 0xFF, p & 0xFF],
                       dim=-1).to(torch.int32)


def _appearance_order_unique(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """First-appearance-ordered unique values of each row of a (N, n) int64
    tensor: (N, 256) packed palette and (N, 256) bool valid mask."""
    batch, n = packed.shape
    sorted_v, sorted_i = torch.sort(packed, dim=-1, stable=True)
    is_start = torch.ones_like(sorted_v, dtype=torch.bool)
    is_start[:, 1:] = sorted_v[:, 1:] != sorted_v[:, :-1]
    order_key = torch.where(is_start, sorted_i, torch.full_like(sorted_i, n))
    order_sorted, perm = torch.sort(order_key, dim=-1, stable=True)
    palette_sorted = torch.gather(sorted_v, -1, perm)
    k = MAX_PALETTE_SIZE
    if n < k:  # fewer pixels than palette slots: pad with invalid sentinels
        order_sorted = torch.cat([order_sorted, order_sorted.new_full((batch, k - n), n)], -1)
        palette_sorted = torch.cat([palette_sorted, palette_sorted.new_zeros((batch, k - n))], -1)
    return palette_sorted[:, :k], order_sorted[:, :k] < n


def grayness(palette_packed: torch.Tensor) -> torch.Tensor:
    """Luma of packed colours in float32, rounded as the JAX package's
    float32 dot on the CPU rounds it: r * c0, then a fused multiply-add of
    g * c1 and one of b * c2 (the alpha term adds 0). A float32 sum in
    another order flips the order of near-equal lumas. Each multiply-add
    is taken exactly in float64 (an 8-bit integer times a float32 plus a
    float32 below 256 spans fewer than 53 bits) and rounded once."""
    rgb = unpack_rgba(palette_packed).to(torch.float64)
    c0, c1, c2 = (float(torch.tensor(c, dtype=torch.float32)) for c in GRAY_COEFFS)
    acc = (rgb[..., 0] * c0).to(torch.float32)
    for channel, coeff in ((1, c1), (2, c2)):
        acc = (acc.to(torch.float64) + rgb[..., channel] * coeff).to(torch.float32)
    return acc


def extract_palettes(images: torch.Tensor, palette_ordering: str = "top2bottom",
                     generator: torch.Generator | None = None) -> torch.Tensor:
    """Unique colours of each (H, W, C) image of a batch (N, H, W, C) as an
    (N, 256, 4) int32 palette. C is a multiple of 4: the joint palette of a
    pair passes the channel-concatenated (N, H, W, 8)."""
    flat = images.to(torch.int32).reshape(images.shape[0], -1, 4)
    if palette_ordering == "bottom2top":
        flat = flat.flip(1)
    palette_packed, valid = _appearance_order_unique(pack_rgba(flat))

    if palette_ordering in ("grayness", "shuffled"):
        if palette_ordering == "grayness":
            key = grayness(palette_packed)
        else:
            if generator is None:
                raise ValueError("palette_ordering='shuffled' needs a torch.Generator")
            key = torch.rand(valid.shape, generator=generator, device=valid.device)
        key = torch.where(valid, key, torch.full_like(key, float("inf")))
        order = torch.argsort(key, dim=-1, stable=True)
        palette_packed = torch.gather(palette_packed, -1, order)
        valid = torch.gather(valid, -1, order)
    elif palette_ordering not in ("top2bottom", "bottom2top"):
        raise ValueError(f"unknown palette ordering {palette_ordering!r}")

    colors = unpack_rgba(palette_packed)
    filler = torch.tensor(INVALID_INDEX_COLOR, dtype=torch.int32, device=colors.device)
    return torch.where(valid[..., None], colors, filler)


def extract_palette(image: torch.Tensor, palette_ordering: str = "top2bottom",
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """One (H, W, C) image -> (256, 4) int32 palette."""
    return extract_palettes(image[None], palette_ordering, generator)[0]


def joint_palettes(sources: torch.Tensor, targets: torch.Tensor, palette_ordering: str,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """The palette each (N, H, W, 4) source/target pair shares, (N, 256, 4)."""
    return extract_palettes(torch.cat([sources, targets], dim=-1), palette_ordering, generator)


def joint_palette_for_pair(source: torch.Tensor, target: torch.Tensor, palette_ordering: str,
                           generator: torch.Generator | None = None) -> torch.Tensor:
    """The palette one (H, W, 4) pair shares, (256, 4)."""
    return joint_palettes(source[None], target[None], palette_ordering, generator)[0]


def rgba_to_indexed(image: torch.Tensor, palette: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 4) images + (N, 256, 4) palettes -> (N, H, W, 1) int32
    index maps, or one (H, W, 4) image + (256, 4) palette -> (H, W, 1).
    The images are integers in [0, 255]; a CUDA tensor goes to kernel K5,
    a CPU tensor to its plain version."""
    single = image.dim() == 3
    if single:
        image, palette = image[None], palette[None]
    out = palette_kernel.rgba_to_indexed(
        image.to(torch.uint8).contiguous(), palette.to(torch.int32).contiguous()
    )
    return out[0] if single else out


def indexed_to_rgba(indexed: torch.Tensor, palette: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 1) index maps + (N, 256, C) palettes -> (N, H, W, C), or
    one (H, W, 1) map + (256, C) palette -> (H, W, C). Labels above the last
    slot decode as the last slot (JAX's gather clamps them)."""
    single = indexed.dim() == 3
    if single:
        indexed, palette = indexed[None], palette[None]
    n, h, w = indexed.shape[:3]
    labels = indexed.reshape(n, h * w).long().clamp(0, palette.shape[1] - 1)
    rows = torch.arange(n, device=indexed.device)[:, None]
    out = palette[rows, labels].reshape(n, h, w, palette.shape[-1])
    return out[0] if single else out


def rgba_to_single_int(values_in_rgba: torch.Tensor) -> torch.Tensor:
    """Pack RGBA into one int32 with the multipliers [2^24, 2^16, 2^8, 0]
    (the alpha's 0 is the reference's, kept). Unused by training; kept for
    API parity. The channels truncate to integers and the sum wraps modulo
    2^32 to int32, so r >= 128 comes out negative, as uint32 arithmetic
    bitcast to int32 gives."""
    v = values_in_rgba.to(torch.int64)
    packed = v[..., 0] * 16777216 + v[..., 1] * 65536 + v[..., 2] * 256 + v[..., 3] * 0
    packed = torch.remainder(packed, 2**32)
    return torch.where(packed >= 2**31, packed - 2**32, packed).to(torch.int32)
