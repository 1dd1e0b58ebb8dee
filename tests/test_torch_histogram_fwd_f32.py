"""The float32 histogram forward on the tensor cores as 3xTF32
(csrc/histogram.cu, hist_fwd_f32: K3a, and K3b in a float32 chain),
checked on the CPU.

The kernel runs only on the card. What a CPU run can hold it to:
  * its TF32 rounding: `tf32_round` below (the integer rounding
    (bits + 2^12) & ~(2^13 - 1)) is round to nearest, ties away from zero,
    to 10 fraction bits, which is what PTX defines `cvt.rna.tf32.f32` to
    do; chip_smoke.py counts the card's instruction against the same
    integer rounding on every finite float32;
  * its order of sums and its products. Every factor is the plain
    forward's (Iy Ku and Kv op for op, float32); each is split into TF32
    parts hi = tf32(a) and lo = tf32(a - hi), and a k-step of 8 pixels
    adds its products lo_A hi_B, hi_A lo_B and hi_A hi_B, one wgmma each,
    to the accumulator; a run of RUN_TILES tiles of 16 pixels starts the
    accumulator at 0 and ends adding it to the warpgroup's float32 sum; the
    two warpgroups take every other tile; the planes of an image's parts
    (forward_block_pixels) are added in index order. Emulated so (each
    wgmma's 8 products summed exactly, rounded to float32 and added in
    float32), the planes stay within
    chip_smoke.py's HIST_TOL[("fwd", "float32")] = 1e-5 of the largest
    value of `histogram_forward_plain`, and within the JAX package's own
    float32 tolerance of JAX K3a in interpret mode. The check is sharp: one
    TF32 product (hi_A hi_B) alone exceeds 1e-5 on the same inputs;
  * the split rule's Python mirror and the bound's arithmetic (`work`).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from palette_and_histo_gan_tpu.ops import histogram_pallas as jp1
from palette_and_histo_gan_tpu_torch.ops import histogram_kernel as hk
from palette_and_histo_gan_tpu_torch.ops.histogram import CHANNEL_TRIPLES

SIGMA = 0.02
BINS = 64
K_STEP = 8  # pixels a wgmma (m64n64k8)
TILE = 16  # pixels a tile: two k-steps
RUN_TILES = 4  # tiles a warpgroup adds into one accumulator run
SMS = 132  # an H100 SXM's multiprocessors
METHODS = ("inverse-quadratic", "RBF")
# (batch, pixels an image): chip_smoke.py's checks, B=1024 aside (its plain
# version alone is minutes on the CPU)
SHAPES = ((4, 4096), (64, 4096), (40, 8384))
TOL = chip_smoke.HIST_TOL[("fwd", "float32")]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread and one BLAS thread while this file runs. The suite
    runs several test processes on the host's cores at once, and a process's
    default of a thread a core makes them contend: in a full run of the
    suite this file took 1,011 s and its [40-8384-inverse-quadratic] case
    410 s, which takes about 11 s in a process of its own."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(threads)


# ------------------------------------------------------------ TF32 rounding


def tf32_round(x: np.ndarray) -> np.ndarray:
    """float32 -> the nearest TF32 value (10 fraction bits), ties away from
    zero, as float32: the bits plus half a TF32 ulp, the 13 low bits
    cleared (a carry into the exponent is the rounding up; past the largest
    finite value it gives infinity)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_by_definition(v: float) -> float:
    """Round the float32 value v to 11 significant bits (TF32's 10 fraction
    bits and its implicit one; subnormals on float32's grid of 2^-149
    coarsened 2^13 times), to nearest with ties away from zero, in exact
    float64 arithmetic; inf past the largest finite TF32 value."""
    if v == 0.0:
        return v
    _, e = math.frexp(abs(v))
    quantum = max(2.0 ** (e - 11), 2.0**-136)
    r = math.floor(abs(v) / quantum + 0.5) * quantum
    if r >= 2.0**128:
        r = math.inf
    return math.copysign(r, v)


def _from_bits(bits) -> np.ndarray:
    return np.asarray(bits, np.uint32).view(np.float32)


TF32_CASES = {
    # x.5 TF32 ulps: every tie rounds away from zero
    "ties": _from_bits([0x3F801000, 0x3F803000, 0x3F800000 | 0x1000 | 0x2000 * 7,
                        0xBF801000, 0x00001000, 0x80003000]),
    "near ties": _from_bits([0x3F800FFF, 0x3F801001, 0xBF800FFF, 0xBF801001]),
    "largest finite": _from_bits([0x7F7FFFFF, 0x7F7FF000, 0x7F7FEFFF, 0x7F7FE000,
                                  0xFF7FFFFF, 0xFF7FF000, 0xFF7FEFFF]),
    "zero": _from_bits([0x00000000, 0x80000000]),
    "negatives": -np.random.default_rng(1).uniform(1e-3, 1e3, 64).astype(np.float32),
    "subnormals": _from_bits([0x00000001, 0x00000FFF, 0x00001FFF, 0x007FFFFF, 0x807FF000]),
    "random bits": _from_bits(np.random.default_rng(2).integers(0, 0x7F800000, 4096)
                              | np.random.default_rng(3).integers(0, 2, 4096) << 31),
}


@pytest.mark.parametrize("case", sorted(TF32_CASES))
def test_tf32_round_is_round_to_nearest_ties_away(case):
    x = TF32_CASES[case]
    got = tf32_round(x)
    want = np.array([_tf32_by_definition(float(v)) for v in x], np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert not np.any(got.view(np.uint32) & 0x1FFF)


# ------------------------------------------------- the kernel's sum, emulated


def _tf32_torch(x: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(tf32_round(x.numpy()))


def _channel_factors(logs, iy, method, channel):
    """A = Iy Ku and B = Kv of one channel, (batch, 64, HW) float32, each
    value the plain forward's op for op."""
    c, p1, p2 = CHANNEL_TRIPLES[channel]
    t = hk.domain(BINS, "cpu")[:, None]
    inv_s = hk.chain_scalar(1.0 / SIGMA**2, torch.float32)
    ku, _ = hk._kernel_values(logs[:, c] - logs[:, p1], t, method, inv_s)
    kv, _ = hk._kernel_values(logs[:, c] - logs[:, p2], t, method, inv_s)
    return iy[:, None, :] * ku, kv


def forward_in_kernel_order(logs, iy, method, passes=3):
    """The float32 forward with the kernel's products and order of sums;
    `passes` 3 is 3xTF32 (lo_A hi_B, hi_A lo_B, hi_A hi_B), 1 is hi_A hi_B
    alone."""
    return forward_in_kernel_order_by_passes(logs, iy, method)[passes]


def forward_in_kernel_order_by_passes(logs, iy, method):
    """{3: 3xTF32, 1: hi_A hi_B alone} of forward_in_kernel_order, from one
    pass over the pixels: the one-pass sum is the sum of the 3xTF32's last
    products alone, in the same order."""
    batch, _, hw = logs.shape
    block_pixels = hk.forward_block_pixels(batch, hw, SMS)
    steps_a_tile = TILE // K_STEP
    planes = {3: [], 1: []}
    for channel in range(3):
        a, b = _channel_factors(logs, iy, method, channel)
        a_hi, b_hi = _tf32_torch(a), _tf32_torch(b)
        a_lo, b_lo = _tf32_torch(a - a_hi), _tf32_torch(b - b_hi)
        pairs = [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)]
        # (batch, 64, k-step, pixel of the step)
        pairs = [(fa.view(batch, BINS, -1, K_STEP), fb.view(batch, BINS, -1, K_STEP))
                 for fa, fb in pairs]
        plane = {3: None, 1: None}
        for start in range(0, hw, block_pixels):
            turns = (min(start + block_pixels, hw) - start) // (2 * TILE)
            # [warpgroup]: the float32 sum, the tensor cores' accumulator
            sums = {passes: torch.zeros(2, batch, BINS, BINS) for passes in (3, 1)}
            for run in range(0, turns, RUN_TILES):
                # the run's k-steps of each warpgroup, in order: turn t of
                # warpgroup wg is tile 2 t + wg of the part
                steps = torch.tensor([
                    [(start + (2 * t + wg) * TILE) // K_STEP + s
                     for t in range(run, min(run + RUN_TILES, turns)) for s in range(steps_a_tile)]
                    for wg in (0, 1)
                ])
                # each (warpgroup, step, batch, 64, 64): one wgmma's sum of
                # 8 products, exact in float64, rounded to float32
                products = [
                    (fa[:, :, steps].permute(2, 3, 0, 1, 4).double()
                     @ fb[:, :, steps].permute(2, 3, 0, 4, 1).double()).float()
                    for fa, fb in pairs
                ]
                for passes, used in ((3, products), (1, products[2:])):
                    acc = torch.zeros_like(sums[passes])
                    for step in range(steps.shape[1]):
                        for p in used:
                            acc = acc + p[:, step]
                    sums[passes] = sums[passes] + acc
            for passes, s in sums.items():
                part = s[0] + s[1]
                plane[passes] = part if plane[passes] is None else plane[passes] + part
        for passes in planes:
            planes[passes].append(plane[passes])
    return {passes: torch.stack(p, dim=1) for passes, p in planes.items()}


def _inputs(batch, hw):
    """chip_smoke.py's seeded inputs: logs and Iy of uint8 pixels / 255."""
    logs, iy, _ = chip_smoke.histogram_inputs(batch, "cpu", 300 + batch, hw)
    return logs, iy


def _plain(logs, iy, method):
    return hk.histogram_forward_plain(logs, iy, size=BINS, method=method, sigma=SIGMA,
                                      chain=torch.float32)


def _rel_to_max(ours, ref):
    return float((ours - ref).abs().max()) / float(ref.abs().max())


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("batch,hw", SHAPES)
def test_3xtf32_sum_stays_within_the_tolerance_and_1xtf32_does_not(batch, hw, method):
    logs, iy = _inputs(batch, hw)
    plain = _plain(logs, iy, method)
    sums = forward_in_kernel_order_by_passes(logs, iy, method)
    ours, one_pass = sums[3], sums[1]
    assert ours.shape == plain.shape == (batch, 3, BINS, BINS)
    assert _rel_to_max(ours, plain) <= TOL
    assert _rel_to_max(one_pass, plain) > TOL


@pytest.mark.parametrize("method", METHODS)
def test_3xtf32_sum_matches_jax_k3a(method):
    """Against JAX K3a in interpret mode on the same pixels, at the float32
    tolerance the JAX package holds its kernel to (rtol 1e-4, atol 1e-6;
    test_torch_histogram_kernel.py::test_plain_forward_matches_jax_kernel)."""
    rng = np.random.default_rng(7)
    flat01 = rng.integers(0, 256, (4, 4096, 3), dtype=np.uint8).astype(np.float32) / 255.0
    logs, iy = hk.logs_and_intensity(torch.from_numpy(flat01))
    ours = forward_in_kernel_order(logs, iy, method).numpy()
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jp1._forward_unnormalized(jnp.asarray(flat01), BINS, method, SIGMA))
    assert ref.shape == ours.shape == (4, 3, BINS, BINS)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-6)


# ------------------------------------------------------- split and bound


def test_split_gives_every_sm_two_blocks_at_batch_4_and_none_at_1024():
    bp = hk.forward_block_pixels(4, 4096, SMS)
    assert 3 * 4 * (4096 // bp) >= 2 * SMS and 4096 % bp == 0
    assert hk.forward_block_pixels(1024, 4096, SMS) == 4096
    assert hk.forward_block_pixels(64, 4096, SMS) == 2048


def test_split_leaves_a_ragged_last_block_at_8384_pixels():
    """A block stages at most 4,096 pixels: 8,384 are 4,096 + 4,096 + 192."""
    hw = 8384
    bp = hk.forward_block_pixels(40, hw, SMS)
    parts = -(-hw // bp)
    last = hw - (parts - 1) * bp
    assert (bp, parts, last) == (4096, 3, 192)
    assert 3 * 40 * parts >= 2 * SMS
    assert bp % 64 == 0 and 0 < last < bp and last % 64 == 0
    # every part, the ragged one too, gives the two warpgroups whole tiles
    assert all(n % (2 * TILE) == 0 for n in (bp, last))


@pytest.mark.parametrize("hw", [64, 128, 4096, 8384, 64 * 257])
def test_split_rule_holds_for_every_batch(hw):
    for batch in range(1, 1200):
        bp = hk.forward_block_pixels(batch, hw, SMS)
        parts = -(-hw // bp)
        assert bp % 64 == 0 and bp <= hk.MAX_FORWARD_BLOCK_PIXELS
        assert bp == hw or bp >= hk.MIN_FORWARD_BLOCK_PIXELS
        assert (parts - 1) * bp < hw <= parts * bp
        if hk.MIN_FORWARD_BLOCK_PIXELS < bp < min(hw, hk.MAX_FORWARD_BLOCK_PIXELS):
            assert 3 * batch * parts >= 2 * SMS


def test_bound_counts_three_tf32_products():
    w = hk.work("fwd", 1024, 4096)
    assert (w["passes"], w["product_type"]) == (3, "tf32")
    products_ms = 1e3 * w["passes"] * w["products"] / chip_smoke.PEAK["tf32"]
    assert chip_smoke.PEAK["tf32"] == 495e12
    assert products_ms == pytest.approx(0.625, abs=1e-3)
    assert chip_smoke.histogram_bound(w) == (pytest.approx(0.625, abs=1e-3), "operations")
    # the float32 backward keeps float32 FMAs; a bfloat16 chain the tensor cores
    assert hk.work("bwd", 1024, 4096)["product_type"] == "float32"
    assert hk.work("fwd", 1024, 4096, chain=torch.bfloat16)["product_type"] == "bfloat16"
