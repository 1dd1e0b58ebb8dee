"""The port's FLOP count, profiling clocks and two image helpers against the
JAX package's.

* `utils/flops.py::train_step_flops_per_image` equals the JAX function
  exactly for the four variants at full and narrow widths and at another
  histogram size;
* `utils/profiling.py`: the marginal clocks and `StepTimer` on fake clocks
  (tests/test_profiling.py's linear and all-negative timers; the StepTimer
  summary equal to the JAX StepTimer's on the same clock); `debug_nans`
  raises on the NaN gradient of a finite forward and only inside its
  scope; `trace` writes a Chrome trace on the CPU; `device_step_seconds`
  raises without a CUDA device;
* `ops/image.py::replace_alpha_with_white` and
  `ops/palette.py::rgba_to_single_int` equal the JAX functions on seeded
  inputs (uint8 and float32, red >= 128 wrapping negative).
"""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palette_and_histo_gan_tpu.ops import image as jimage
from palette_and_histo_gan_tpu.ops import palette as jpalette
from palette_and_histo_gan_tpu.utils import flops as jflops
from palette_and_histo_gan_tpu.utils import profiling as jprofiling
from palette_and_histo_gan_tpu_torch.ops import image as timage
from palette_and_histo_gan_tpu_torch.ops import palette as tpalette
from palette_and_histo_gan_tpu_torch.utils import flops, profiling
from tests.test_torch_train_step import NARROW, configs

VARIANTS = ("baseline-no-aug", "baseline", "histogram", "indexed")


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("widths", [{}, NARROW, dict(histogram_size=32, **NARROW)],
                         ids=["full", "narrow", "narrow-32-bins"])
def test_flops_equal_the_jax_count(variant, widths):
    jax_config, config = configs(variant, **widths)
    ours = flops.train_step_flops_per_image(config)
    assert ours == jflops.train_step_flops_per_image(jax_config)
    assert ours > 0


def test_flops_full_width_histogram_step():
    # 1.3 GFLOP an image for the baseline step's networks; the histogram
    # adds 3.5 evaluations of three 64 x 64 x 4096 products
    _, base = configs("baseline")
    _, hist = configs("histogram")
    extra = flops.train_step_flops_per_image(hist) - flops.train_step_flops_per_image(base)
    assert extra == 3.5 * 3 * 2.0 * 64 * 64 * 4096
    assert 1e9 < flops.train_step_flops_per_image(base) < 1e11


def test_marginal_step_seconds_linear_timer():
    calls = []

    def timed(n):
        calls.append(n)
        return 0.5 + 0.01 * n

    assert profiling.marginal_step_seconds(timed, steps=20) == pytest.approx(0.01)
    assert calls == [5, 20] * 3


def test_marginal_step_seconds_all_negative_returns_none():
    seq = iter([10.0, 5.0, 10.0, 5.0, 10.0, 5.0])
    assert profiling.marginal_step_seconds(lambda n: next(seq), steps=20) is None


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def test_marginal_call_seconds_fetches_and_cancels_the_fixed_cost(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(profiling.time, "perf_counter", clock)
    fetched = []

    class Out(torch.Tensor):
        def item(self):
            fetched.append(True)
            clock.now += 0.5  # a fixed fetch cost a run
            return super().item()

    def fn(x):
        clock.now += 0.01
        return {"loss": (x * 2).as_subclass(Out)}

    got = profiling.marginal_call_seconds(fn, (torch.ones(3),), n_long=16, n_short=4)
    assert got == pytest.approx(0.01)
    assert len(fetched) == 1 + 2 * 3  # warm-up, then three (short, long) pairs


def test_step_timer_matches_the_jax_timer(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(profiling.time, "perf_counter", clock)
    monkeypatch.setattr(jprofiling.time, "perf_counter", clock)
    ours, theirs = profiling.StepTimer(), jprofiling.StepTimer()
    assert ours.summary(4) == theirs.summary(4) == {}
    for dt in (0.25, 0.75):
        ours.start()
        theirs.start()
        clock.now += dt
        ours.stop({"loss": torch.tensor([1.0, 2.0])})
        theirs.stop({"loss": jnp.asarray([1.0, 2.0])})
    assert ours.times == theirs.times == [0.25, 0.75]
    assert ours.summary(4) == theirs.summary(4)
    assert ours.summary(4) == {"mean_step_seconds": 0.5, "steps_per_second": 2.0,
                               "images_per_second": 8.0}


def _nan_gradient_of_a_finite_forward():
    x = torch.tensor([-1.0, 4.0], requires_grad=True)
    y = torch.where(x > 0, torch.sqrt(x), torch.zeros_like(x)).sum()
    assert torch.isfinite(y)
    y.backward()
    return x.grad


def test_debug_nans_raises_on_a_nan_gradient():
    with pytest.raises(RuntimeError, match="returned nan"):
        with profiling.debug_nans():
            _nan_gradient_of_a_finite_forward()
    # off outside the scope and with enable=False: the NaN goes through
    assert torch.isnan(_nan_gradient_of_a_finite_forward()).any()
    with profiling.debug_nans(False):
        assert torch.isnan(_nan_gradient_of_a_finite_forward()).any()
    assert not torch.is_anomaly_enabled()


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    a = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "trace")):
        (a @ a).sum().item()
    paths = glob.glob(str(tmp_path / "trace" / "trace_*.json"))
    assert len(paths) == 1
    with open(paths[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_device_step_seconds_raises_without_a_cuda_device():
    assert not torch.cuda.is_available()
    ran = []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.device_step_seconds(ran.append, 4)
    assert ran == []


def test_replace_alpha_with_white_matches_jax():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (2, 16, 16, 4)).astype(np.float32)
    img[..., 3] *= rng.random((2, 16, 16)) < 0.5  # half the pixels transparent
    ours = timage.replace_alpha_with_white(torch.from_numpy(img))
    want = np.asarray(jimage.replace_alpha_with_white(jnp.asarray(img)))
    assert ours.shape == (2, 16, 16, 3)
    np.testing.assert_array_equal(ours.numpy(), want)
    assert (ours.numpy()[img[..., 3] == 0] == 255).all()


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_rgba_to_single_int_matches_jax(dtype):
    rng = np.random.default_rng(4)
    v = rng.integers(0, 256, (3, 8, 8, 4)).astype(dtype)
    if dtype == np.float32:
        v += rng.random(v.shape).astype(np.float32) * 0.99  # truncated, as astype does
    ours = tpalette.rgba_to_single_int(torch.from_numpy(v))
    want = np.asarray(jpalette.rgba_to_single_int(jnp.asarray(v)))
    assert ours.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(ours.numpy(), want)
    assert (want < 0).any()  # red >= 128 wraps past int32's top
