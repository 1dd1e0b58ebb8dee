"""The port's previews and patch-map strips
(palette_and_histo_gan_tpu_torch/utils/visualization.py) against the JAX
package's display functions (palette_and_histo_gan_tpu/utils/
visualization.py) on the same numpy arrays:

  * `_to_display`, `_show_unit` and `upscale_patches` give the JAX arrays
    exactly, the dark palette decode included;
  * every tile cut out of the port's grid and strip is the JAX display
    array quantized as the port states (RGBA over white, patch maps gray,
    rint(255 v)), scaled up SCALE times; the gutters are white;
  * the stdlib PNG encoder's files decode to the same array through PIL
    and through the port's native decoder (native/png_io.py).
"""

import numpy as np
import pytest
from PIL import Image

from palette_and_histo_gan_tpu.utils import visualization as jviz
from palette_and_histo_gan_tpu_torch.native import png_io
from palette_and_histo_gan_tpu_torch.utils import visualization as viz


def quantize(display: np.ndarray) -> np.ndarray:
    """The port's stated quantization of a [0, 1] display array."""
    v = np.asarray(display, np.float64)
    if v.ndim == 2:
        v = np.stack([v] * 3, axis=-1)
    elif v.shape[-1] == 4:
        v = v[..., :3] * v[..., 3:] + (1.0 - v[..., 3:])
    return np.rint(v * 255.0).astype(np.uint8)


def tile(canvas, row, col, img_size=64):
    y, x = viz.tile_origin(row, col, img_size)
    n = img_size * viz.SCALE
    return canvas[y:y + n, x:x + n]


def scaled(img):
    return np.repeat(np.repeat(img, viz.SCALE, axis=0), viz.SCALE, axis=1)


def assert_gutters_white(canvas, rows, cols, img_size=64):
    mask = np.ones(canvas.shape[:2], bool)
    for r in range(rows):
        for c in range(cols):
            y, x = viz.tile_origin(r, c, img_size)
            mask[y:y + img_size * viz.SCALE, x:x + img_size * viz.SCALE] = False
    assert (canvas[mask] == 255).all()


def dark_decode():
    """Palette decodes whose values are all <= 1 on the 0-255 scale."""
    dark = np.zeros((2, 8, 8, 4), np.int32)
    dark[..., 3] = 1
    dark[0, 0, 0] = 1
    return dark


def test_display_functions_equal_jax():
    rng = np.random.default_rng(0)
    img = rng.uniform(-1.5, 1.5, (3, 64, 64, 4)).astype(np.float32)
    ours, theirs = viz._to_display(img), jviz._to_display(img)
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)
    for arr in (dark_decode(), rng.integers(0, 256, (2, 8, 8, 4)).astype(np.uint8),
                np.asarray([[0.25, 1.5, -0.1]], np.float32)):
        ours, theirs = viz._show_unit(arr), jviz._show_unit(arr)
        assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)
    np.testing.assert_allclose(viz._show_unit(dark_decode())[0, 0, 0], 1.0 / 255.0)
    for p, size in ((3, 8), (32, 64), (30, 64)):
        patches = rng.uniform(0, 1, (p, p, 1)).astype(np.float32)
        assert np.array_equal(viz.upscale_patches(patches, size),
                              jviz.upscale_patches(patches, size))


@pytest.mark.parametrize("indexed", [False, True])
def test_preview_grid_tiles_are_the_jax_display_arrays(indexed):
    rng = np.random.default_rng(1)
    if indexed:  # palette decodes on the 0-255 scale, one of them dark
        src, tgt = (rng.integers(0, 256, (3, 64, 64, 4)).astype(np.int32) for _ in range(2))
        gen = np.zeros((3, 64, 64, 4), np.int32)
        gen[..., 3] = 1
        show = jviz._show_unit
    else:
        src, tgt, gen = (rng.uniform(-1.2, 1.2, (3, 64, 64, 4)).astype(np.float32)
                         for _ in range(3))
        show = jviz._to_display
    grid = viz.preview_grid(src, tgt, gen, values_in_unit_range=indexed)
    step = 64 * viz.SCALE + viz.GUTTER
    assert grid.dtype == np.uint8 and grid.shape == (viz.GUTTER + 3 * step, viz.GUTTER + 3 * step, 3)
    for row in range(3):
        for col, images in enumerate((src, tgt, gen)):
            assert np.array_equal(tile(grid, row, col), scaled(quantize(show(images[row]))))
    assert_gutters_white(grid, 3, 3)


def test_discriminator_strip_tiles_are_the_jax_display_arrays():
    rng = np.random.default_rng(2)
    source, target, generated = (rng.uniform(-1, 1, (64, 64, 4)).astype(np.float32)
                                 for _ in range(3))
    real_p, fake_p = (rng.uniform(0, 1, (32, 32, 1)).astype(np.float32) for _ in range(2))
    strip = viz.discriminator_debug_figure(source, target, generated, real_p, fake_p)
    panels = [jviz._to_display(source), jviz._to_display(target),
              jviz.upscale_patches(real_p, 64), jviz._to_display(generated),
              jviz.upscale_patches(fake_p, 64)]
    assert strip.shape[:2] == (viz.GUTTER + 64 * viz.SCALE + viz.GUTTER,
                               viz.GUTTER + 5 * (64 * viz.SCALE + viz.GUTTER))
    for col, panel in enumerate(panels):
        assert np.array_equal(tile(strip, 0, col), scaled(quantize(panel)))
    assert_gutters_white(strip, 1, 5)
    # a palette decode's strip
    pal_imgs = [rng.integers(0, 256, (64, 64, 4)).astype(np.int32) for _ in range(3)]
    strip = viz.discriminator_debug_figure(*pal_imgs, real_p, fake_p, values_in_unit_range=True)
    for col, img in zip((0, 1, 3), pal_imgs):
        assert np.array_equal(tile(strip, 0, col), scaled(quantize(jviz._show_unit(img))))


def test_png_round_trips_through_pil_and_the_native_decoder(tmp_path):
    rng = np.random.default_rng(3)
    grid = viz.preview_grid(*(rng.uniform(-1, 1, (2, 64, 64, 4)).astype(np.float32)
                              for _ in range(3)))
    path = str(tmp_path / "sub" / "grid.png")
    viz._write_png(grid, path)
    with Image.open(path) as im:
        assert im.mode == "RGB"
        assert np.array_equal(np.asarray(im), grid)
    decoded = png_io.decode_png_rgba(path, *grid.shape[:2])
    assert decoded is not None, "the native decoder did not build or refused the file"
    assert np.array_equal(decoded[..., :3], grid) and (decoded[..., 3] == 255).all()
    with pytest.raises(ValueError):
        viz._write_png(grid[..., :2], path)
