"""The bfloat16 histogram backward on the tensor cores (csrc/histogram.cu,
hist_bwd_bf16, K4b and K4c in a bfloat16 chain), checked on the CPU.

The kernel runs only on the card. What a CPU run can hold it to:
  * its order of sums: wgmma accumulates m1 and da in float32 k-step by
    k-step (16 bins each), and a thread sums its 16 bins 8m + 2 (lane % 4)
    + {0, 1} of each per-pixel reduction before two shuffles across the
    quad. The same pieces as the plain backward (`_kernel_values`,
    `domain`, `chain_scalar`), summed in that order on 64x64 images, stay
    within chip_smoke.py's HIST_TOL[("bwd", "bfloat16")] = 8e-3 of the
    largest row of `histogram_backward_plain`, and within 1e-2 of JAX K4b
    and K4c in interpret mode, the tolerance of
    test_torch_histogram_kernel.py::test_plain_backward_matches_jax_kernel.
    JAX runs in a process of its own with XLA's excess precision off, so
    that its bfloat16 operations round as the TPU's do: with it on, XLA on
    the CPU keeps float32 between fused bfloat16 operations, and at 64
    bins that alone moves one RBF gradient of the plain version 1.01e-2
    from JAX K4c. Measured: rows within 1.4e-3 of the plain version's
    largest row; gradients within 1.9e-4 of JAX K4c and 9.6e-3 of JAX K4b,
    the plain version's own distances but one (K4b's algebra rounds
    elsewhere, as test_torch_histogram_kernel.py's tolerances say);
  * its one reciprocal for both kernels: for every bfloat16 input it takes,
    a float32 reciprocal within two ulps of the correctly rounded one rounds
    to the same bfloat16;
  * the work a call must do, from which chip_smoke.py computes the bound.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from palette_and_histo_gan_tpu_torch.ops import histogram_kernel as hk
from palette_and_histo_gan_tpu_torch.ops.histogram import CHANNEL_TRIPLES, matmul_f32

SIGMA = 0.02
BINS = 64
K_STEP = 16


def _sum_in_k_steps(a, b):
    """a (B, M, K) @ b (B, K, N) in float32, one k-step of 16 at a time."""
    acc = None
    for k in range(0, a.shape[-1], K_STEP):
        part = matmul_f32(a[..., k:k + K_STEP], b[:, k:k + K_STEP])
        acc = part if acc is None else acc + part
    return acc


def _reduce_in_quads(a, b):
    """sum over bins of the bfloat16 products a * b (B, 64, HW), as a quad
    of lanes sums them: lane q adds bins 8m + 2q, 8m + 2q + 1 (m = 0..7) in
    float32, then (lane 0 + lane 1) + (lane 2 + lane 3); rounded to
    bfloat16."""
    prod = (a * b).float()
    lanes = []
    for q in range(4):
        s = torch.zeros_like(prod[:, 0])
        for m in range(8):
            for e in range(2):
                s = s + prod[:, 8 * m + 2 * q + e]
        lanes.append(s)
    return ((lanes[0] + lanes[1]) + (lanes[2] + lanes[3])).to(torch.bfloat16).float()


def _backward_in_kernel_order(logs, iy, g, method):
    """The bfloat16 backward with the kernel's order of sums."""
    chain = torch.bfloat16
    t = hk.domain(BINS, logs.device).to(chain)[:, None]
    inv_s = hk.chain_scalar(1.0 / SIGMA**2, chain)
    scale = -2.0 / SIGMA**2
    rows = [0.0] * 4
    for ch, (c, p1, p2) in enumerate(CHANNEL_TRIPLES):
        ku, su = hk._kernel_values((logs[:, c] - logs[:, p1]).to(chain), t, method, inv_s)
        kv, sv = hk._kernel_values((logs[:, c] - logs[:, p2]).to(chain), t, method, inv_s)
        gc = g[:, ch].to(chain)
        m1 = _sum_in_k_steps(gc.transpose(1, 2), ku).to(chain)
        da = _sum_in_k_steps(gc, kv).to(chain)
        s_y, s_u, s_v = _reduce_in_quads(m1, kv), _reduce_in_quads(da, su), _reduce_in_quads(m1, sv)
        d_iu = iy * (scale * s_u)
        d_iv = iy * (scale * s_v)
        rows[3] = rows[3] + s_y
        rows[c] = rows[c] + (d_iu + d_iv)
        rows[p1] = rows[p1] - d_iu
        rows[p2] = rows[p2] - d_iv
    return torch.stack(rows, dim=1)


def _inputs(batch):
    """Pixels (B, 4096, 3) in (0, 1) and a cotangent (B, 3, 64, 64)."""
    rng = np.random.default_rng(batch)
    x = rng.uniform(0.02, 0.98, (batch, 4096, 3)).astype(np.float32)
    g = (rng.standard_normal((batch, 3, BINS, BINS)) * 1e-2).astype(np.float32)
    return x, g


_JAX_BACKWARDS = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from jax.experimental.pallas import tpu as pltpu
from palette_and_histo_gan_tpu.ops import histogram_pallas2 as jp2
from palette_and_histo_gan_tpu.ops import histogram_pallas3 as jp3

inputs = np.load(sys.argv[1])
sigma, bins = float(inputs["sigma"]), int(inputs["bins"])
out = {}
with pltpu.force_tpu_interpret_mode():
    for key in inputs.files:
        if key.startswith("x-"):
            method, batch = key[2:].split(":")
            x, g = jnp.asarray(inputs[key]), jnp.asarray(inputs["g-" + batch])
            (out[f"K4b:{method}:{batch}"],) = jp2._hist2_core_bwd(bins, method, sigma, jnp.bfloat16, x, g)
            out[f"K4c:{method}:{batch}"] = jp3.backward_unnormalized_pallas3(
                x, jnp.moveaxis(g, 1, -1), bins, method, sigma, dtype=jnp.bfloat16)
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""
METHODS = ("inverse-quadratic", "RBF")
BATCHES = (3, 8)


@pytest.fixture(scope="module")
def jax_bf16_backwards(tmp_path_factory):
    """JAX K4b's and K4c's bfloat16 backwards on every case, each bfloat16
    operation rounded (a process of its own: XLA reads the flag when its
    CPU backend starts)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    folder = tmp_path_factory.mktemp("bwd_bf16")
    inputs = {"sigma": np.float32(SIGMA), "bins": np.int32(BINS)}
    for batch in BATCHES:
        x, inputs[f"g-{batch}"] = _inputs(batch)
        for method in METHODS:
            inputs[f"x-{method}:{batch}"] = x
    np.savez(folder / "in.npz", **inputs)
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false",
               JAX_PLATFORMS="cpu", PYTHONPATH=repo)
    subprocess.run(
        [sys.executable, "-c", _JAX_BACKWARDS, str(folder / "in.npz"), str(folder / "out.npz")],
        cwd=repo, env=env, check=True, capture_output=True, timeout=600,
    )
    return dict(np.load(folder / "out.npz"))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kernel", ["K4b", "K4c"])
@pytest.mark.parametrize("batch", BATCHES)
def test_kernel_order_of_sums_stays_within_the_tolerance(jax_bf16_backwards, kernel, method, batch):
    x, g = _inputs(batch)
    flat01, g_t = torch.from_numpy(x), torch.from_numpy(g)
    logs, iy = hk.logs_and_intensity(flat01)
    ours = _backward_in_kernel_order(logs, iy, g_t, method)
    plain = hk.histogram_backward_plain(
        logs, iy, g_t, size=BINS, method=method, sigma=SIGMA, chain=torch.bfloat16
    )
    assert ours.shape == plain.shape == (batch, 4, 4096)
    tol = chip_smoke.HIST_TOL[("bwd", "bfloat16")]
    assert float((ours - plain).abs().max()) <= tol * float(plain.abs().max())
    ref = jax_bf16_backwards[f"{kernel}:{method}:{batch}"]
    got = hk.finish(ours, flat01, iy).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-2 * np.abs(ref).max(), rtol=0)


def test_near_reciprocals_of_bfloat16_values_round_alike():
    """The kernel takes rcp.approx (at most 1 float32 ulp from 1 / v) for
    K4b's exact reciprocal too: for every bfloat16 v in [1, 2^126), the
    float32 values up to two ulps either side of the correctly rounded
    1 / v all round to its bfloat16."""
    bits = torch.arange(0x3F80, 0x7E80, dtype=torch.int32)  # bfloat16 1.0 .. 2^125 * (2 - 2^-7)
    v = (bits << 16).view(torch.float32)
    assert torch.equal(v.to(torch.bfloat16).float(), v)
    exact = v.reciprocal()
    want = exact.to(torch.bfloat16)
    for ulps in (-2, -1, 1, 2):
        near = exact.view(torch.int32) + ulps  # all positive normals: one ulp a step
        assert torch.equal(near.view(torch.float32).to(torch.bfloat16), want), ulps


@pytest.mark.parametrize(
    "batch,fwd,bwd",
    [
        # (products, elementwise, bytes) of the forward and the backward
        (1024, (103_079_215_104, 8_858_370_048, 117_440_512),
         (206_158_430_208, 16_106_127_360, 184_549_376)),
        (4, (402_653_184, 34_603_008, 458_752), (805_306_368, 62_914_560, 720_896)),
    ],
)
def test_work_counts_of_the_histogram_kernels(batch, fwd, bwd):
    for direction, want in (("fwd", fwd), ("bwd", bwd)):
        w = hk.work(direction, batch, 4096)
        assert (w["products"], w["elementwise"], w["bytes"]) == want
    if batch == 1024:
        # the bounds chip_smoke.py reports: the bfloat16 rows set by the
        # elementwise chain, the float32 rows by their products
        def bound(direction, chain):
            w = hk.work(direction, batch, 4096)
            return chip_smoke.bound(w["bytes"], (w["products"], chain), (w["elementwise"], "float32"))

        for direction, chain, ms in (("fwd", "bfloat16", 0.1322), ("bwd", "bfloat16", 0.2404),
                                     ("fwd", "float32", 1.5385), ("bwd", "float32", 3.0770)):
            t, by = bound(direction, chain)
            assert by == "operations" and t == pytest.approx(ms, rel=1e-3)


def test_work_counts_per_cell():
    """11 operations a (pixel, bin, channel) forward, 20 backward; a bad
    direction raises."""
    cells = 2 * 3 * 64 * 4096
    for direction, n in (("fwd", 11), ("bwd", 20)):
        assert hk.work(direction, 2, 4096)["elementwise"] == n * cells
    with pytest.raises(ValueError, match="direction"):
        hk.work("sideways", 2, 4096)
