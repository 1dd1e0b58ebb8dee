"""The float32 histogram backward (csrc/histogram.cu, hist_bwd_f32: K4a, and
K4b and K4c in a float32 chain), checked on the CPU.

The kernel runs only on the card. What a CPU run can hold it to:
  * its order of sums. A thread owns 8 bins q + 8 r (q = its lane % 8) of
    m1 or da at 8 pixels: each product is summed over its 64 bins in order,
    one multiply-add a bin, and each per-pixel sum over bins is the
    thread's 8 bins in order, then three exchanges across the 8 lanes
    (1, 2, 4 apart). The same pieces as the plain backward
    (`_kernel_values`, `domain`, `chain_scalar`), summed in that order on
    64x64 images, stay within chip_smoke.py's HIST_TOL[("bwd", "float32")]
    = 1e-4 of the largest row of `histogram_backward_plain` (measured
    1.7e-7), and, through `finish`, within 1e-4 of the largest gradient of
    JAX K4a in interpret mode, the float32 tolerance of
    test_torch_histogram_kernel.py::test_plain_backward_matches_jax_kernel
    (measured 4.9e-5: K4a's own algebra is another association);
  * the slope weights k^2 x (RBF: k x), which the kernel no longer keeps in
    shared memory but recomputes from the stored kernel value and
    x = diff - t where the sums use them: bit for bit `_kernel_values`';
  * the pixels a block owns (`backward_block_pixels`, the launch's rule in
    Python) at the card's 132 multiprocessors: the smallest tile at B=4,
    512 at B=64, 1,024 at B=1024;
  * the wrappers' signatures: the `approx` flag is gone.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from palette_and_histo_gan_tpu.ops import histogram_pallas as jp1
from palette_and_histo_gan_tpu_torch.ops import histogram_kernel as hk
from palette_and_histo_gan_tpu_torch.ops import histogram_pallas3 as tp3
from palette_and_histo_gan_tpu_torch.ops.histogram import CHANNEL_TRIPLES

SIGMA = 0.02
BINS = 64
LANES = 8  # lanes of a pixel group; a thread's bins are lane + 8 r
METHODS = ("inverse-quadratic", "RBF")
BATCHES = (3, 8)


def _multiply_add(a, b, acc):
    """fmaf(a, b, acc) on float32 tensors: the product is exact in float64,
    the sum rounded there and then to float32."""
    return (a.double() * b.double() + acc.double()).float()


def _product_in_bin_order(gc_rows, k):
    """out[b, q, p] = sum_i gc_rows[b, q, i] k[b, i, p], one multiply-add a
    bin i in order, as a thread's accumulator takes them."""
    acc = torch.zeros(k.shape[0], gc_rows.shape[1], k.shape[2])
    for i in range(gc_rows.shape[2]):
        acc = _multiply_add(gc_rows[:, :, i, None], k[:, i, None, :], acc)
    return acc


def _sum_over_bins(values, weights):
    """sum over bins of values * weights (B, 64, HW): lane q adds the
    products of bins q, q + 8, ..., q + 56 in order, then the lanes add
    theirs 1, 2 and 4 apart."""
    prod = values * weights
    lanes = []
    for q in range(LANES):
        s = torch.zeros_like(prod[:, 0])
        for r in range(BINS // LANES):
            s = s + prod[:, q + LANES * r]
        lanes.append(s)
    for off in (1, 2, 4):
        lanes = [lanes[q] + lanes[q ^ off] for q in range(LANES)]
    assert all(torch.equal(lanes[0], other) for other in lanes[1:])  # every lane holds the sum
    return lanes[0]


def _slope_as_the_kernel_recomputes_it(k, diff, t, method):
    x = diff[:, None, :] - t
    return k * x if method == "RBF" else k * (k * x)


def _backward_in_kernel_order(logs, iy, g, method):
    """The float32 backward with the kernel's order of sums."""
    chain = torch.float32
    t = hk.domain(BINS, logs.device).to(chain)[:, None]
    inv_s = hk.chain_scalar(1.0 / SIGMA**2, chain)
    scale = -2.0 / SIGMA**2
    rows = [0.0] * 4
    for ch, (c, p1, p2) in enumerate(CHANNEL_TRIPLES):
        du, dv = logs[:, c] - logs[:, p1], logs[:, c] - logs[:, p2]
        ku, _ = hk._kernel_values(du, t, method, inv_s)
        kv, _ = hk._kernel_values(dv, t, method, inv_s)
        su = _slope_as_the_kernel_recomputes_it(ku, du, t, method)
        sv = _slope_as_the_kernel_recomputes_it(kv, dv, t, method)
        gc = g[:, ch]
        m1 = _product_in_bin_order(gc.transpose(1, 2), ku)  # (B, j, HW)
        da = _product_in_bin_order(gc, kv)  # (B, i, HW)
        s_y, s_u, s_v = _sum_over_bins(m1, kv), _sum_over_bins(da, su), _sum_over_bins(m1, sv)
        d_iu = iy * (scale * s_u)
        d_iv = iy * (scale * s_v)
        rows[3] = rows[3] + s_y
        rows[c] = rows[c] + (d_iu + d_iv)
        rows[p1] = rows[p1] - d_iu
        rows[p2] = rows[p2] - d_iv
    return torch.stack(rows, dim=1)


def _inputs(batch):
    """Pixels (B, 4096, 3) in (0, 1) and a cotangent (B, 3, 64, 64)."""
    rng = np.random.default_rng(200 + batch)
    x = rng.uniform(0.02, 0.98, (batch, 4096, 3)).astype(np.float32)
    g = (rng.standard_normal((batch, 3, BINS, BINS)) * 1e-2).astype(np.float32)
    return x, g


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("batch", BATCHES)
def test_kernel_order_of_sums_stays_within_the_tolerance(method, batch):
    x, g = _inputs(batch)
    flat01, g_t = torch.from_numpy(x), torch.from_numpy(g)
    logs, iy = hk.logs_and_intensity(flat01)
    ours = _backward_in_kernel_order(logs, iy, g_t, method)
    plain = hk.histogram_backward_plain(
        logs, iy, g_t, size=BINS, method=method, sigma=SIGMA, chain=torch.float32
    )
    assert ours.shape == plain.shape == (batch, 4, 4096)
    tol = chip_smoke.HIST_TOL[("bwd", "float32")]
    assert float((ours - plain).abs().max()) <= tol * float(plain.abs().max())
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jp1._backward_unnormalized(jnp.asarray(x), jnp.asarray(g), BINS, method, SIGMA))
    got = hk.finish(ours, flat01, iy).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("method", METHODS)
def test_recomputed_slope_weights_equal_the_plain_versions(method):
    rng = np.random.default_rng(7)
    diff = torch.from_numpy(rng.uniform(-6.0, 6.0, (3, 4096)).astype(np.float32))
    t = hk.domain(BINS, "cpu")[:, None]
    inv_s = hk.chain_scalar(1.0 / SIGMA**2, torch.float32)
    k, slope = hk._kernel_values(diff, t, method, inv_s)
    again = _slope_as_the_kernel_recomputes_it(k, diff, t, method)
    assert torch.equal(again, slope)
    assert float(slope.abs().max()) > 0.0


@pytest.mark.parametrize(
    "batch,f32,bf16", [(4, 64, 128), (64, 512, 512), (1024, 1024, 1024), (133, 1024, 1024),
                       (66, 1024, 1024), (65, 512, 512)],
)
def test_backward_block_pixels_at_132_multiprocessors(batch, f32, bf16):
    """Halved from 1,024 while batch x blocks an image < 2 x 132, down to
    one 64-pixel tile (float32) or one a warpgroup (bfloat16)."""
    assert hk.backward_block_pixels(batch, 4096, 132, torch.float32) == f32
    assert hk.backward_block_pixels(batch, 4096, 132, torch.bfloat16) == bf16
    for chain, pixels in ((torch.float32, f32), (torch.bfloat16, bf16)):
        blocks = batch * -(-4096 // pixels)
        assert blocks >= 2 * 132 or pixels == hk.MIN_BLOCK_PIXELS[chain]
        assert pixels == hk.MAX_BLOCK_PIXELS or batch * -(-4096 // (2 * pixels)) < 2 * 132


def test_backward_block_pixels_of_a_ragged_image():
    """8,384 pixels (131 tiles): blocks of 64 at B=2; at B=40, the shape
    chip_smoke.py checks, nine blocks an image, the last with 192 pixels."""
    assert hk.backward_block_pixels(2, 8384, 132, torch.float32) == 64
    for chain in (torch.float32, torch.bfloat16):
        assert hk.backward_block_pixels(40, 8384, 132, chain) == 1024
    assert 8384 - 8 * 1024 == 192
    assert (40, 8384) in chip_smoke.HIST_CHECK_SHAPES and (64, 4096) in chip_smoke.HIST_CHECK_SHAPES


def test_the_approx_flag_is_gone():
    for fn in (hk.histogram_backward, hk.histogram_backward_cuda, hk.histogram_backward_plain,
               tp3.backward_unnormalized_pallas3):
        assert "approx" not in inspect.signature(fn).parameters, fn.__name__
    with pytest.raises(ValueError, match="CUDA device"):
        hk.reciprocal_mismatches("cpu")
