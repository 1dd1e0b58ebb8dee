"""The frozen yardstick against the program's own counts at full width, and
the data and weights the benchmark hands the program."""

import pytest
import torch

from benchmark.counts import attribution, flops, histogram_work, traffic, weights
from benchmark.harness import spec
from benchmark.models import pix2pix
from palette_and_histo_gan_tpu_torch import roofline as port_roofline
from palette_and_histo_gan_tpu_torch.config import config_for_variant
from palette_and_histo_gan_tpu_torch.ops import histogram_kernel
from palette_and_histo_gan_tpu_torch.train.state import build_models
from palette_and_histo_gan_tpu_torch.utils import flops as port_flops
from palette_and_histo_gan_tpu_torch.utils import roofline as port_peaks

CONFIGS = ("histogram", "indexed")


def _port_config(name, **kw):
    c = spec.data_file("configs", name)
    settings = dict(c["settings"], **kw)
    for key in ("down_filters", "up_filters"):
        settings[key] = tuple(settings[key])
    return c, config_for_variant(c["variant"], **settings)


@pytest.mark.parametrize("name", CONFIGS)
def test_flops_equal_the_programs_at_full_width(name):
    c, config = _port_config(name)
    arch = flops.Arch.of(c)
    assert flops.train_step_flops_per_image(arch) == port_flops.train_step_flops_per_image(config)
    assert flops.generator_fwd_flops(arch) == port_flops._generator_fwd_flops(config)
    assert flops.discriminator_fwd_flops(arch) == port_flops._discriminator_fwd_flops(config)


def test_peaks_equal_the_programs():
    for key, value in flops_peaks().items():
        assert port_peaks.PEAK[key] == value


def flops_peaks():
    from benchmark.counts.peaks import PEAK

    return PEAK


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("chain", ["bfloat16", "float32"])
def test_histogram_work_equals_the_programs_with_one_pass(direction, chain):
    dtype = torch.bfloat16 if chain == "bfloat16" else torch.float32
    for batch in (4, 256, 1024):
        ours = histogram_work.work(direction, batch, 4096, 64, chain)
        theirs = histogram_kernel.work(direction, batch, 4096, 64, dtype)
        for key in ("products", "elementwise", "bytes"):
            assert ours[key] == theirs[key]
        assert ours["passes"] == 1
        expected_type = "bfloat16" if chain == "bfloat16" else "tf32"
        assert ours["product_type"] == expected_type


def test_histogram_step_floor_at_b1024():
    # bfloat16: 2 forwards of 0.132 ms and a backward of 0.240 ms, each
    # bound by its elementwise chain at float32's 67 TFLOP/s; float32: the
    # products at one TF32 pass, 0.208 and 0.416 ms
    floor = histogram_work.step_floor_seconds(1024, 64, "bfloat16", 64 * 64)
    assert floor == pytest.approx(2 * 0.1320e-3 + 0.2403e-3, rel=2e-3)
    floor = histogram_work.step_floor_seconds(1024, 64, "float32", 64 * 64)
    assert floor == pytest.approx(2 * 0.2082e-3 + 0.4164e-3, rel=2e-3)


def test_attribution_names_equal_the_programs():
    assert attribution.RANGES == pix2pix.RANGES == port_roofline.RANGES
    assert attribution.LAYOUT_KERNELS == port_roofline.LAYOUT_KERNELS
    assert attribution.LAYOUT_PARENTS == port_roofline.LAYOUT_PARENTS
    assert attribution.backward_group("G-fwd") == "G-bwd"
    assert attribution.backward_group("loss") == "loss-bwd"


@pytest.mark.parametrize("seed", [0, 47, 2**31 + 11, 2**40 + 3])
def test_sub_seeds_are_under_2_31_and_repeat(seed):
    a, b = traffic.sub_seeds(seed), traffic.sub_seeds(seed)
    assert a == b and set(a) == set(traffic.SEED_NAMES)
    assert all(0 <= v < 2**31 for v in a.values())
    assert len(set(a.values())) == len(a)


@pytest.mark.parametrize("name", CONFIGS)
def test_traffic_repeats_from_its_seed(name):
    config = spec.data_file("configs", name)
    mix = {"train_pairs": 6, "test_pairs": 2}
    one = traffic.make_splits(config, mix, 5, "cpu")
    two = traffic.make_splits(config, mix, 5, "cpu")
    other = traffic.make_splits(config, mix, 6, "cpu")
    for x, y in zip(one["train"] + one["test"], two["train"] + two["test"]):
        assert torch.equal(x, y)
    assert not torch.equal(one["train"][0], other["train"][0])
    src = one["train"][0]
    if name == "indexed":
        assert src.dtype == torch.int32 and src.shape == (6, 64, 64, 1)
        assert int(src.min()) >= 0 and int(src.max()) <= 255
    else:
        assert src.dtype == torch.uint8 and src.shape == (6, 64, 64, 4)
        transparent = src[..., 3] == 0
        assert int(src[transparent].sum()) == 0


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("width", [8, None])
def test_weights_fill_the_programs_parameters(name, width):
    kw = {} if width is None else {"down_filters": (width,) * 6, "up_filters": (width,) * 6}
    c, config = _port_config(name, **kw)
    if width is not None:
        c["settings"].update(down_filters=[width] * 6, up_filters=[width] * 6)
    g, d = build_models(config, "cpu", 0)
    w = weights.draw(pix2pix.parameter_shapes(c), 3, "cpu")
    for net, module in (("generator", g), ("discriminator", d)):
        params = dict(module.named_parameters())
        assert list(w[net]) == list(params)
        for k, p in params.items():
            assert w[net][k].shape == p.shape
    kernels = torch.cat([t.reshape(-1) for n in w for k, t in w[n].items() if k.endswith("weight")])
    assert abs(float(kernels.std()) - 0.02) < 2e-3
    assert torch.equal(w["generator"]["head.bias"], torch.zeros_like(w["generator"]["head.bias"]))
