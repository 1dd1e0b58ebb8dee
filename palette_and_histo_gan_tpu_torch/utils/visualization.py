"""Preview grids and discriminator patch maps, drawn in numpy alone.

Counterpart of palette_and_histo_gan_tpu/utils/visualization.py:
  - `preview_grid`: one row per example, the columns Input | Target |
    Generated (the reference's preview_generated_images_during_training);
  - `discriminator_debug_figure`: the strip Source | Target | D(target) |
    Generated | D(generated), the sigmoid patch maps upscaled to the image
    by repeat and pad (its debug_discriminator_patches).
`_to_display`, `_show_unit` and `upscale_patches` compute what the JAX
module's do.

The JAX module draws matplotlib figures and writes them with PIL; the
port's machines need neither. Each 64x64 image becomes a tile scaled up
SCALE times (nearest), the tiles are laid out with GUTTER-pixel white
gutters, and `_write_png` writes the array as a PNG with zlib and struct.
A tile is quantized as rint(255 * v) of the display array v in [0, 1]:
RGBA composited over white (as matplotlib shows it on a white figure), a
patch map as gray. The figures carry no titles: the JAX ones read
"Generated (0.2k)" over the generated column and "Discriminated target
0.512" / "Discriminated generated 0.488" (the patch maps' means) over the
maps. The Trainer prints the step and the two means on stdout instead and
puts the step in the file name.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

SCALE = 4  # a tile is the image scaled up this many times
GUTTER = 8  # white pixels around and between tiles


def _to_display(img: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> [0, 1] for display (reference: img * 0.5 + 0.5)."""
    return np.clip(np.asarray(img) * 0.5 + 0.5, 0.0, 1.0)


def _show_unit(img: np.ndarray) -> np.ndarray:
    """Display scaling for values_in_unit_range callers: integer images
    (palette decodes) are on the 0-255 scale however dark they are, float
    images already in [0, 1]."""
    img = np.asarray(img)
    if np.issubdtype(img.dtype, np.integer):
        img = img / 255.0
    return np.clip(img, 0.0, 1.0)


def to_rgb8(display: np.ndarray) -> np.ndarray:
    """A [0, 1] display array -> HWC uint8 RGB: RGBA over white, gray
    (H, W) or (H, W, 1) to three channels, rint(255 * v)."""
    v = np.asarray(display, np.float64)
    if v.ndim == 2:
        v = v[..., None]
    if v.shape[-1] == 4:
        alpha = v[..., 3:]
        v = v[..., :3] * alpha + (1.0 - alpha)
    elif v.shape[-1] == 1:
        v = np.repeat(v, 3, axis=-1)
    return np.rint(v * 255.0).astype(np.uint8)


def tile_origin(row: int, col: int, img_size: int) -> tuple[int, int]:
    """(y, x) of the top-left pixel of a tile in a grid or strip."""
    step = img_size * SCALE + GUTTER
    return GUTTER + row * step, GUTTER + col * step


def _layout(tiles: list[list[np.ndarray]]) -> np.ndarray:
    """Rows of equally sized uint8 RGB images -> one white canvas."""
    img_size = tiles[0][0].shape[0]
    rows, cols = len(tiles), len(tiles[0])
    step = img_size * SCALE + GUTTER
    canvas = np.full((GUTTER + rows * step, GUTTER + cols * step, 3), 255, np.uint8)
    for r, row in enumerate(tiles):
        for c, tile in enumerate(row):
            y, x = tile_origin(r, c, img_size)
            big = np.repeat(np.repeat(tile, SCALE, axis=0), SCALE, axis=1)
            canvas[y:y + big.shape[0], x:x + big.shape[1]] = big
    return canvas


def _write_png(data: np.ndarray, save_name: str) -> None:
    """HWC uint8 RGB -> an 8-bit RGB PNG (colour type 2, filter 0 on every
    row), with zlib and struct only."""
    data = np.ascontiguousarray(data)
    if data.dtype != np.uint8 or data.ndim != 3 or data.shape[2] != 3:
        raise ValueError(f"expected HWC uint8 RGB, got {data.dtype} {data.shape}")
    h, w, _ = data.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)  # a filter byte 0 a row
    raw[:, 1:] = data.reshape(h, 3 * w)

    def chunk(tag: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(tag + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", crc)

    png = b"".join((
        b"\x89PNG\r\n\x1a\n",
        chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)),
        chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)),
        chunk(b"IEND", b""),
    ))
    folder = os.path.dirname(save_name)
    if folder:
        os.makedirs(folder, exist_ok=True)
    with open(save_name, "wb") as f:
        f.write(png)


def preview_grid(
    sources: np.ndarray,
    targets: np.ndarray,
    generated: np.ndarray,
    save_name: str | None = None,
    step: int | None = None,
    values_in_unit_range: bool = False,
) -> np.ndarray:
    """Rows of [Input, Target, Generated] as HWC uint8; written to
    `save_name` when one is given. values_in_unit_range=True for images
    already in [0, 1] or palette decodes on the 0-255 scale (the indexed
    variant). `step` is the JAX signature's title step; the grid has no
    title."""
    show = _show_unit if values_in_unit_range else _to_display
    tiles = [
        [to_rgb8(show(img[i])) for img in (sources, targets, generated)]
        for i in range(len(sources))
    ]
    data = _layout(tiles)
    if save_name is not None:
        _write_png(data, save_name)
    return data


def upscale_patches(patches: np.ndarray, img_size: int = 64) -> np.ndarray:
    """(P, P, 1) sigmoid patch map -> (img_size, img_size) by repeat + pad
    (pix2pix_model.py:178-191)."""
    patches = np.asarray(patches)
    num_patches = patches.shape[0]
    factor = img_size // num_patches
    pad_before = (img_size - num_patches * factor) // 2
    pad_after = (img_size - num_patches * factor) - pad_before
    up = np.repeat(np.repeat(patches, factor, axis=0), factor, axis=1)
    up = np.pad(up, [[pad_before, pad_after], [pad_before, pad_after], [0, 0]])
    return up[:, :, 0]


def discriminator_debug_figure(
    source: np.ndarray,
    target: np.ndarray,
    generated: np.ndarray,
    real_patches: np.ndarray,
    fake_patches: np.ndarray,
    save_name: str | None = None,
    values_in_unit_range: bool = False,
) -> np.ndarray:
    """[Source, Target, D(target), Generated, D(generated)] strip as HWC
    uint8, the patch maps gray on [0, 1] (pix2pix_model.py:198-229)."""
    img_size = np.asarray(source).shape[0]
    show = _show_unit if values_in_unit_range else _to_display
    panels = [
        show(source),
        show(target),
        np.clip(upscale_patches(real_patches, img_size), 0.0, 1.0),
        show(generated),
        np.clip(upscale_patches(fake_patches, img_size), 0.0, 1.0),
    ]
    data = _layout([[to_rgb8(p) for p in panels]])
    if save_name is not None:
        _write_png(data, save_name)
    return data
