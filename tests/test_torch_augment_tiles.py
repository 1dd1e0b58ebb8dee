"""The fused augmentation kernel's map from threads to pixels
(csrc/augment.cu, mirrored by ops/augment_kernel.py::thread_pixel and
::source_pixel), checked on the CPU.

A grid of (PIXELS / THREADS, B) blocks: each thread writes one output
pixel of both images of its block's pair, gathered at the pair's shift.
Here the map covers every output pixel of a pair exactly once, with
neighbouring threads on neighbouring pixels, and, for every shift that
`draw_params` can draw and for a pair left as it is (keep == 0),
gathering through the map and rotating the gathered pixels gives exactly
what `augment_plain` gives on the same draws. The kernel's arithmetic
itself is held to the plain version on the card (chip_smoke.py), and so
are its branch-free divisions to IEEE division; here the normalize's
division formula is held to exact rational arithmetic on a sample.
"""

import math
from fractions import Fraction

import numpy as np
import pytest
import torch

from palette_and_histo_gan_tpu_torch.ops import augment as ta
from palette_and_histo_gan_tpu_torch.ops import augment_kernel as ak

BLOCKS = ak.PIXELS // ak.THREADS


def _drawable(factor):
    lo, hi = (round(f * ta.SIDE) for f in factor)
    return range(lo, hi + 1)


def _pixels_in_thread_order():
    return [ak.thread_pixel(block, thread) for block in range(BLOCKS) for thread in range(ak.THREADS)]


def test_every_output_pixel_is_written_once():
    written = np.zeros(ak.PIXELS, np.int64)
    np.add.at(written, _pixels_in_thread_order(), 1)
    assert np.all(written == 1)


def test_neighbouring_threads_write_neighbouring_pixels():
    """A warp's 32 lanes write 32 consecutive pixels of a row: 256
    contiguous bytes an image in bfloat16, 512 in float32."""
    for block in range(BLOCKS):
        for warp in range(ak.THREADS // 32):
            lanes = [ak.thread_pixel(block, 32 * warp + lane) for lane in range(32)]
            assert lanes == list(range(lanes[0], lanes[0] + 32))
            assert lanes[0] // ak.SIDE == lanes[-1] // ak.SIDE


def test_drawable_shifts_are_the_plain_draws():
    gen = torch.Generator()
    gen.manual_seed(0)
    _, sy, sx, _ = ta.draw_params(gen, 20000, 0.8)
    assert set(sy.tolist()) <= set(_drawable(ta.HEIGHT_FACTOR))
    assert set(sx.tolist()) <= set(_drawable(ta.WIDTH_FACTOR))
    assert min(sy.tolist()) == -10 and max(sx.tolist()) == 8


def _through_the_map(img, delta, sy, sx, keep, out_dtype, normalize_out):
    """One image batch augmented as the kernel's threads do it: each output
    pixel gathered from the input image (zero outside), rotated if the
    pair is kept, normalized, cast."""
    b = img.shape[0]
    staged = ta.to_float_rgba(img).reshape(b, ak.PIXELS, 4)
    out = torch.full((b, ak.PIXELS, 4), float("nan"))
    pixels = _pixels_in_thread_order()
    for i in range(b):
        draws = int(sy[i]), int(sx[i]), int(keep[i])
        src = torch.tensor([ak.source_pixel(p, *draws) for p in pixels])
        v = torch.where((src >= 0)[:, None], staged[i, src.clamp_min(0)], torch.zeros(4))
        if keep[i]:
            r, g, bl = ta.hue_rotate(v[:, 0], v[:, 1], v[:, 2], delta[i])
            v = torch.stack([r, g, bl, v[:, 3]], dim=-1)
        out[i, torch.tensor(pixels)] = v
    out = out.reshape(b, ta.SIDE, ta.SIDE, 4)
    if normalize_out:
        out = out / 127.5 - 1.0
    return out.to(out_dtype)


@pytest.mark.parametrize("keep", [1, 0])
@pytest.mark.parametrize("out_dtype,normalize_out", [(torch.float32, False), (torch.bfloat16, True)])
def test_gather_through_the_map_equals_the_plain_version(keep, out_dtype, normalize_out):
    """Every drawable (sy, sx) once, and a shift past the image (all zero
    fill), on one seeded packed pair each."""
    shifts = [(y, x) for y in _drawable(ta.HEIGHT_FACTOR) for x in _drawable(ta.WIDTH_FACTOR)]
    shifts.append((-64, 64))
    b = len(shifts)
    rng = np.random.default_rng(11)
    src, tgt = (
        torch.from_numpy(rng.integers(0, 256, (b, ak.PIXELS * 4), dtype=np.uint8)).view(torch.int32)
        for _ in range(2)
    )
    delta = torch.from_numpy(rng.uniform(-0.5, 0.5, b).astype(np.float32))
    sy = torch.tensor([y for y, _ in shifts], dtype=torch.int32)
    sx = torch.tensor([x for _, x in shifts], dtype=torch.int32)
    keeps = torch.full((b,), keep, dtype=torch.int32)
    want = ta.augment_plain(src, tgt, delta, sy, sx, keeps, normalize_out=normalize_out,
                            out_dtype=out_dtype)
    for img, ref in zip((src, tgt), want):
        got = _through_the_map(img, delta, sy, sx, keeps, out_dtype, normalize_out)
        assert torch.equal(got, ref)
    if keep:
        assert torch.all(want[0][-1] == (-1.0 if normalize_out else 0.0))


# --------------------------------------------- the normalize's division


def _round_f32(x: Fraction) -> float:
    """x rounded to the nearest float32 (ties to even; float32's subnormal
    grid below 2^-126), as an exact float."""
    if x == 0:
        return 0.0
    sign, x = (-1.0 if x < 0 else 1.0), abs(x)
    e = math.floor(math.log2(x))
    while Fraction(2) ** e > x:
        e -= 1
    while Fraction(2) ** (e + 1) <= x:
        e += 1
    quantum = Fraction(2) ** (max(e, -126) - 23)
    n, rem = divmod(x, quantum)
    if rem > quantum / 2 or (rem == quantum / 2 and n % 2):
        n += 1
    return sign * float(n * quantum)


def _fma(a, b, c):
    return _round_f32(Fraction(a) * Fraction(b) + Fraction(c))


def _div_127_5(v: float) -> float:
    """csrc/augment.cu::div_127_5: the quotient through the rounded
    reciprocal of 127.5, one step on its exact residual."""
    inv = _round_f32(Fraction(2, 255))
    q0 = _round_f32(Fraction(v) * Fraction(inv))
    return _fma(_fma(-127.5, q0, v), inv, q0)


def test_branch_free_normalize_is_ieee_division():
    """The normalize v / 127.5 - 1 through div_127_5 gives the bits of IEEE
    division on every channel value of integer input, on float32 values
    across [0, 255] and on small and large ones (the card checks every
    float32: chip_smoke.py)."""
    rng = np.random.default_rng(5)
    values = [float(v) for v in range(256)]
    values += rng.uniform(0.0, 255.0, 3000).astype(np.float32).tolist()
    values += [float(np.float32(v)) for v in (1e-40, 3e-38, 1e-20, 1e20, 3e38, 254.99998)]
    for v in values:
        want = _round_f32(Fraction(v) / Fraction(127.5))
        got = _div_127_5(v)
        assert _round_f32(Fraction(got) - 1) == _round_f32(Fraction(want) - 1), v
        assert got == want, v
