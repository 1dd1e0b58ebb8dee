"""The bfloat16 histogram forward on the tensor cores (csrc/histogram.cu,
hist_fwd_bf16, K3b in a bfloat16 chain), checked on the CPU.

The kernel runs only on the card. What a CPU run can hold it to:
  * its order of sums. Every factor is the plain forward's (`_kernel_values`,
    `domain`, `chain_scalar`: Ku, Kv and Iy Ku rounded to bfloat16); only
    the float32 sum over the 4,096 pixels runs in another order: wgmma adds
    a k-step of 16 pixels at a time, each of the block's two warpgroups
    takes every other 64-pixel tile into a sum of its own, and the first
    warpgroup's sum + the second's is the plane. Summed in that order on
    64x64 images, the planes stay within chip_smoke.py's
    HIST_TOL[("fwd", "bfloat16")] = 1e-4 of the largest value of
    `histogram_forward_plain` (measured 8e-7: float32 sums of 4,096
    positive terms), and within 5e-3 of the largest value of JAX K3b in
    interpret mode, the tolerance of
    test_torch_histogram_kernel.py::test_plain_forward_matches_jax_kernel
    in a bfloat16 chain. JAX runs in a process of its own with XLA's excess
    precision off, so that its bfloat16 operations round as the TPU's do;
  * the launch counters: the bfloat16 chain's launches count once more in
    `bf16_launches`, under the forward's names too, and `reset_launches`
    sets both to 0. On the CPU nothing launches.
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
K_STEP = 16  # pixels a wgmma
TILE = 64  # pixels a tile: four k-steps
WARPGROUPS = 2
METHODS = ("inverse-quadratic", "RBF")
BATCHES = (3, 8)


def _forward_in_kernel_order(logs, iy, method):
    """The bfloat16 forward with the kernel's order of sums."""
    chain = torch.bfloat16
    t = hk.domain(BINS, logs.device).to(chain)[:, None]
    inv_s = hk.chain_scalar(1.0 / SIGMA**2, chain)
    iy_c = iy.to(chain)[:, None, :]
    hw = logs.shape[-1]
    planes = []
    for c, p1, p2 in CHANNEL_TRIPLES:
        ku, _ = hk._kernel_values((logs[:, c] - logs[:, p1]).to(chain), t, method, inv_s)
        kv, _ = hk._kernel_values((logs[:, c] - logs[:, p2]).to(chain), t, method, inv_s)
        a = iy_c * ku
        assert a.dtype == kv.dtype == chain
        sums = []
        for warpgroup in range(WARPGROUPS):
            acc = torch.zeros(logs.shape[0], BINS, BINS)
            for base in range(warpgroup * TILE, hw, WARPGROUPS * TILE):
                for p in range(base, base + TILE, K_STEP):
                    acc = acc + matmul_f32(a[:, :, p:p + K_STEP], kv[:, :, p:p + K_STEP].transpose(1, 2))
            sums.append(acc)
        planes.append(sums[0] + sums[1])
    return torch.stack(planes, dim=1)


def _inputs(batch):
    """Pixels (B, 4096, 3) in (0, 1)."""
    rng = np.random.default_rng(100 + batch)
    return rng.uniform(0.02, 0.98, (batch, 4096, 3)).astype(np.float32)


_JAX_FORWARDS = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from jax.experimental.pallas import tpu as pltpu
from palette_and_histo_gan_tpu.ops import histogram_pallas2 as jp2

inputs = np.load(sys.argv[1])
sigma, bins = float(inputs["sigma"]), int(inputs["bins"])
out = {}
with pltpu.force_tpu_interpret_mode():
    for key in inputs.files:
        if key.startswith("logs-"):
            logs, iy = jnp.asarray(inputs[key]), jnp.asarray(inputs["iy-" + key[5:]])
            for method in ("inverse-quadratic", "RBF"):
                out[f"{method}:{key[5:]}"] = jp2._forward_unnormalized(
                    logs, iy, bins, method, sigma, jnp.bfloat16)
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


@pytest.fixture(scope="module")
def jax_bf16_forwards(tmp_path_factory):
    """JAX K3b's bfloat16 forward on every case's logs and Iy, each
    bfloat16 operation rounded (a process of its own: XLA reads the flag
    when its CPU backend starts). The kernel's own inputs are handed over,
    not the pixels: the two frameworks' float32 logs may differ in the
    last place, and with sigma = 0.02 a pixel whose bfloat16 du then rounds
    the other way moves a bin by more than any tolerance of the kernel."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    folder = tmp_path_factory.mktemp("fwd_bf16")
    inputs = {"sigma": np.float32(SIGMA), "bins": np.int32(BINS)}
    for batch in BATCHES:
        logs, iy = hk.logs_and_intensity(torch.from_numpy(_inputs(batch)))
        inputs[f"logs-{batch}"], inputs[f"iy-{batch}"] = logs.numpy(), iy.numpy()
    np.savez(folder / "in.npz", **inputs)
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false",
               JAX_PLATFORMS="cpu", PYTHONPATH=repo)
    subprocess.run(
        [sys.executable, "-c", _JAX_FORWARDS, str(folder / "in.npz"), str(folder / "out.npz")],
        cwd=repo, env=env, check=True, capture_output=True, timeout=600,
    )
    return dict(np.load(folder / "out.npz"))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("batch", BATCHES)
def test_kernel_order_of_sums_stays_within_the_tolerance(jax_bf16_forwards, method, batch):
    flat01 = torch.from_numpy(_inputs(batch))
    logs, iy = hk.logs_and_intensity(flat01)
    ours = _forward_in_kernel_order(logs, iy, method)
    plain = hk.histogram_forward_plain(
        logs, iy, size=BINS, method=method, sigma=SIGMA, chain=torch.bfloat16
    )
    assert ours.shape == plain.shape == (batch, 3, BINS, BINS)
    tol = chip_smoke.HIST_TOL[("fwd", "bfloat16")]
    assert float((ours - plain).abs().max()) <= tol * float(plain.abs().max())
    ref = jax_bf16_forwards[f"{method}:{batch}"]
    assert ref.shape == (batch, 3, BINS, BINS)
    np.testing.assert_allclose(ours.numpy(), ref, atol=5e-3 * np.abs(ref).max(), rtol=0)


def test_plain_forward_through_the_dispatch_is_the_plain_version():
    """A CPU tensor takes the plain version, whatever the chain."""
    flat01 = torch.from_numpy(_inputs(3)[:, :256])
    logs, iy = hk.logs_and_intensity(flat01)
    kw = dict(size=BINS, method="inverse-quadratic", sigma=SIGMA, chain=torch.bfloat16)
    got = hk.histogram_forward(logs, iy, kernel="K3b", **kw)
    assert torch.equal(got, hk.histogram_forward_plain(logs, iy, **kw))


def test_bfloat16_launch_counters_cover_the_forward_and_reset():
    names = ["K3a", "K3b", "K4a", "K4b", "K4c"]
    assert sorted(hk.launches) == sorted(hk.bf16_launches) == names
    hk.launches["K3b"] = 5
    hk.bf16_launches["K3b"] = 3
    hk.bf16_launches["K4c"] = 2
    hk.reset_launches()
    assert all(n == 0 for n in hk.launches.values())
    assert all(n == 0 for n in hk.bf16_launches.values())
    # on the CPU the plain versions run: nothing counts
    flat01 = torch.from_numpy(_inputs(3)[:, :64])
    logs, iy = hk.logs_and_intensity(flat01)
    hk.histogram_forward(logs, iy, size=BINS, method="RBF", sigma=SIGMA,
                         chain=torch.bfloat16, kernel="K3b")
    assert hk.launches["K3b"] == hk.bf16_launches["K3b"] == 0


def test_smoke_counts_two_bfloat16_forwards_and_one_backward_a_step():
    """What chip_smoke.py requires of the b1024 bf16 chunks: each step runs
    the histogram forward on the real and on the fake image and the
    backward on the fake's only."""
    assert chip_smoke.BF16_LAUNCHES_A_STEP == {"K3b": 2, "K4b": 1, "K4c": 1}
    assert set(chip_smoke.BF16_LAUNCHES_A_STEP) <= set(hk.bf16_launches)
    for label, (_, names) in chip_smoke.HIST_CONFIGS.items():
        assert set(names) <= set(chip_smoke.HIST_KERNELS), label
