"""Kernel K6, the InstanceNorm moments: the port's plain version against the
TPU kernel, and the A/B module that runs it.

* `ops/moments.py::moments_plain` (the CPU path of K6) against the JAX
  `scripts/bench_in_stats.py::stats_pallas` in interpret mode, at B = 8
  and 16, bfloat16 and float32, at small shapes of the four (HW, C)
  ratios of the script's decoder shapes (HW / C = 1/4, 2, 16, 128), the
  port's input contiguous (NCHW) and channels_last (NHWC, the TPU
  kernel's layout): within rtol 1e-5 of the largest |value| of each
  output (the JAX kernel sums in float32, the plain version in float64);
* at B = 5, which the TPU kernel's grid of B // 8 blocks leaves unwritten,
  every row against a float64 numpy reference, and the 1 / HW taken as a
  float32 multiplier, not a division (HW = 15);
* the `mean2` the networks' bfloat16 InstanceNorm computes (the square in
  bfloat16) equal to JAX `stats_xla`'s, and more than 1e-4 from K6's
  (the square in float32);
* the refusals, and a CUDA tensor going to the kernel (here: raising),
  never to the plain version;
* `python -m palette_and_histo_gan_tpu_torch.bench_in_stats --device cpu`
  on one small shape.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

SCRIPTS = os.path.join(os.path.dirname(__file__), "..", "scripts")
if SCRIPTS not in sys.path:
    sys.path.insert(0, SCRIPTS)

import bench_in_stats as jax_bench  # noqa: E402

from palette_and_histo_gan_tpu_torch import bench_in_stats  # noqa: E402
from palette_and_histo_gan_tpu_torch.models.networks import InstanceNorm  # noqa: E402
from palette_and_histo_gan_tpu_torch.ops import moments as mo  # noqa: E402

RTOL = 1e-5
# (H, W, C) at the script's four HW / C ratios: 1/4, 2, 16, 128
SMALL_SHAPES = ((4, 4, 64), (8, 8, 32), (16, 16, 16), (32, 32, 8))
DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16), "float32": (jnp.float32, torch.float32)}
_JAX_STATS = jax.jit(jax_bench.stats_pallas)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def nhwc_input(shape, dtype: str, seed: int) -> np.ndarray:
    """Seeded N(0, 1) NHWC values, rounded to `dtype`, as float32."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return np.asarray(jnp.asarray(x, DTYPES[dtype][0]).astype(jnp.float32))


def port_input(x_nhwc: np.ndarray, dtype: str, layout: str) -> torch.Tensor:
    """The NHWC values as a (B, C, H, W) tensor: contiguous or channels_last."""
    x = torch.from_numpy(x_nhwc.copy()).to(DTYPES[dtype][1]).permute(0, 3, 1, 2)
    if layout == "nchw":
        x = x.contiguous()
    assert mo.layout(x) == layout
    return x


def assert_close_of_max(got: torch.Tensor, want: np.ndarray, rtol: float, what: str):
    want = np.asarray(want, np.float64)
    err = np.abs(got.double().numpy() - want).max()
    assert err <= rtol * np.abs(want).max(), (what, err, np.abs(want).max())


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("hwc", SMALL_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("batch", [8, 16])
def test_plain_matches_jax_stats_pallas(batch, dtype, hwc, layout):
    x = nhwc_input((batch, *hwc), dtype, seed=batch + hwc[0])
    want_m, want_m2 = _JAX_STATS(jnp.asarray(x, DTYPES[dtype][0]))
    mean, mean2 = mo.moments_plain(port_input(x, dtype, layout))
    assert mean.shape == mean2.shape == (batch, hwc[2]) and mean.dtype == mean2.dtype == torch.float32
    assert_close_of_max(mean, want_m, RTOL, "mean")
    assert_close_of_max(mean2, want_m2, RTOL, "mean2")


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("hwc", [(3, 5, 16), (8, 8, 32)], ids=lambda s: "x".join(map(str, s)))
def test_plain_writes_every_row_at_b5(hwc, dtype, layout):
    x = nhwc_input((5, *hwc), dtype, seed=5)
    mean, mean2 = mo.moments(port_input(x, dtype, layout))  # a CPU tensor: the plain version
    x64 = x.astype(np.float64)
    hw = hwc[0] * hwc[1]
    np.testing.assert_allclose(mean.numpy(), x64.mean((1, 2)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(mean2.numpy(), (x64 * x64).mean((1, 2)), rtol=1e-6, atol=1e-7)
    # float32 sums times float32(1 / HW), as the TPU kernel multiplies
    sums = np.float32(x64.sum((1, 2)))
    np.testing.assert_array_equal(mean.numpy(), sums * np.float32(1.0 / hw))
    if hw == 15:  # a division would differ from the multiplier somewhere
        assert not np.array_equal(sums * np.float32(1.0 / hw), sums / np.float32(hw))


def test_jax_kernel_leaves_rows_past_whole_blocks_unwritten():
    """The reference's own fault, which the port does not copy: at B = 12
    the JAX kernel's grid (B // 8) computes rows 0-7 only."""
    x = nhwc_input((12, 4, 4, 8), "bfloat16", seed=12)
    want = np.asarray(jax_bench.stats_xla(jnp.asarray(x, jnp.bfloat16))[0])
    got = np.asarray(_JAX_STATS(jnp.asarray(x, jnp.bfloat16))[0])
    np.testing.assert_allclose(got[:8], want[:8], rtol=1e-5, atol=1e-6)
    mean, _ = mo.moments_plain(port_input(x, "bfloat16", "nhwc"))
    np.testing.assert_allclose(mean.numpy(), want, rtol=1e-5, atol=1e-6)


class RecordMeans(TorchFunctionMode):
    """Records the result of every Tensor.mean call in its scope."""

    def __init__(self):
        super().__init__()
        self.means = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.Tensor.mean:
            self.means.append(out)
        return out


def test_networks_mean2_is_stats_xla_not_k6():
    """Fact: the networks' bfloat16 InstanceNorm squares in bfloat16, as JAX
    `stats_xla` does; K6 squares in float32. At (16, 8, 8, 32) the two
    mean2 differ by ~1e-3 against a largest value of ~1.5."""
    x = nhwc_input((16, 8, 8, 32), "bfloat16", seed=0)
    xla_m, xla_m2 = (np.asarray(v) for v in jax_bench.stats_xla(jnp.asarray(x, jnp.bfloat16)))
    xt = port_input(x, "bfloat16", "nhwc")
    with RecordMeans() as record, torch.no_grad():
        InstanceNorm(32)(xt)
    net_m, net_m2 = (v.reshape(16, 32) for v in record.means)
    np.testing.assert_allclose(net_m.numpy(), xla_m, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(net_m2.numpy(), xla_m2, rtol=1e-6, atol=1e-7)
    for a, b in zip(bench_in_stats.stats_torch(xt), (net_m, net_m2)):
        assert torch.equal(a, b)  # the A/B's form A is the networks' form
    k6_m, k6_m2 = mo.moments_plain(xt)
    np.testing.assert_allclose(k6_m.numpy(), xla_m, rtol=1e-6, atol=1e-7)
    gap = float((k6_m2 - net_m2).abs().max())
    assert 1e-4 < gap < 1e-2, gap


@pytest.mark.parametrize(
    "make, message",
    [
        (lambda: torch.zeros(2, 3, 4), "B, C, H, W"),
        (lambda: torch.zeros(2, 3, 4, 4, dtype=torch.float16), "bfloat16 or float32"),
        (lambda: torch.zeros(2, 3, 4, 4, dtype=torch.int32), "bfloat16 or float32"),
        (lambda: torch.zeros(0, 3, 4, 4), "empty"),
        (lambda: torch.zeros(2, 3, 4, 0), "empty"),
        (lambda: torch.zeros(2, 3, 4, 4).transpose(2, 3), "contiguous or channels_last"),
        (lambda: torch.zeros(2, 3, 8, 4)[:, :, ::2], "contiguous or channels_last"),
    ],
)
def test_refusals(make, message):
    for fn in (mo.moments, mo.moments_plain, mo.moments_cuda):
        with pytest.raises(ValueError, match=message):
            fn(make())


def test_cuda_tensor_goes_to_the_kernel_never_to_the_plain_version(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        mo.moments_cuda(torch.zeros(2, 3, 4, 4))
    with pytest.raises(ValueError, match="CUDA or a CPU tensor"):
        mo.moments(torch.zeros(2, 3, 4, 4, device="meta"))

    def no_plain(x):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(mo, "moments_plain", no_plain)
    with FakeTensorMode():
        x = torch.zeros(2, 3, 4, 4, dtype=torch.bfloat16, device="cuda")
        huge = torch.empty(2**16, 2**8, 2**4, 2**4, device="cuda")
    with pytest.raises(ValueError, match="fewer than 2"):
        mo.moments(huge)
    before = dict(mo.launches)
    # no nvcc and no card here: building or launching the kernel raises
    with pytest.raises((RuntimeError, AssertionError)):
        mo.moments(x)
    assert mo.launches == before


def test_layouts_give_the_same_bits():
    x = port_input(nhwc_input((5, 8, 8, 16), "float32", seed=1), "float32", "nhwc")
    for a, b in zip(mo.moments_plain(x), mo.moments_plain(x.contiguous())):
        assert torch.equal(a, b)


def test_ab_module_on_cpu(capsys):
    assert bench_in_stats.build_parser().parse_args([]).device == "cuda"
    assert bench_in_stats.main(["--device", "cpu", "--shape", "8,32,8,8"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("cpu")
    rows = [json.loads(line) for line in lines[1:]]
    assert [r["layout"] for r in rows] == ["nchw", "nhwc"]
    for r in rows:
        assert r["shape"] == [8, 32, 8, 8] and r["device"] == "cpu" and r["pool"] == 4
        assert r["A_vs_C"] < 1e-2 and r["B_vs_C"] < 1e-2
        assert r["mean_A_vs_C"] < 1e-6 < r["mean2_A_vs_C"]
        assert r["bytes"] == 2 * 8 * 32 * 64 + 2 * 4 * 8 * 32
        assert r["C_calls"] == 1 + 3 * (48 + 12) + 2  # the check, the marginal runs
        assert all(r[f"{f}_ms"] > 0 and r[f"{f}_event_ms"] is None and r[f"{f}_device_ms"] is None
                   for f in "ABC")
        assert r["B_output"] in ("float32 (out_dtype)", "bfloat16, upcast")
    assert mo.launches["K6"] == 0


def test_ab_module_needs_a_card_by_default():
    # tests/conftest.py hides every CUDA device from the tests
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench_in_stats.main(["--shape", "8,32,8,8"])


def test_instance_norm_inputs_are_the_generators_eleven():
    """The statistics a step computes: one per InstanceNorm of the one
    generator forward, the A/B's four decoder shapes the last four."""
    seen = bench_in_stats.instance_norm_inputs(2, torch.bfloat16, "cpu")
    assert [s[1:] for s, _ in seen] == [
        (128, 16, 16), (256, 8, 8), (512, 4, 4), (512, 2, 2), (512, 1, 1),
        (512, 2, 2), (512, 4, 4), (256, 8, 8), (128, 16, 16), (64, 32, 32), (32, 64, 64)]
    assert [(2, *s[1:]) for s in bench_in_stats.SHAPES] == [s for s, _ in seen[-4:]]
    assert {layout for _, layout in seen} <= {"nchw", "nhwc", "other"}
