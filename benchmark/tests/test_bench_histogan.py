"""The HistoGAN cell (configs/histogan.json, models/histogan.py, entries/
histogan_chunk.py) on the CPU at narrow widths: the model module has the
ten parts and names the port's parameters and buffers at the published
widths, a run through run.py is correct and the half-batch fault is not,
counts/histogan_flops.py equals FlopCounterMode over one period of the
reference, and the new metrics read nothing where their spans and groups
are missing (a program without HistoGAN).

NARROW's limits: the reference follows the program's phases (models/
histogan.py), so sound runs on the CPU at these widths, the histogram
loss on, read loss_gap 8.2e-8 to 1.1e-7, grad_gap 7.0e-7 to 1.1e-6 and
change_gap 6.9e-8 to 1.4e-7, and the half-batch fault 0.32 to 0.83, 1.73
to 8.62 and 0.080 to 0.132 (seeds 1, 2, 3, 2**31 + 77)."""

import json
import os
import types

import pytest
import torch

from benchmark.counts import histogan_flops
from benchmark.counts import weights as weights_gen
from benchmark.harness import spec
from benchmark.models import histogan
from benchmark.tests.test_bench_faults import run_cell

CELL = "histogan.b64-f32"
NARROW = {
    "settings": {"resolution": 32, "z_dim": 32, "w_dim": 32, "mapping_layers": 3,
                 "channel_base": 256, "channel_max": 32, "histogram_resize": 20,
                 "projection_widths": [64, 32, 32], "mbstd_group": 4},
    "traffic": {"batch_size": 8, "train_pairs": 16, "steps_per_chunk": 2, "trace_chunks": 1},
    "limits": {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-4},
}


def test_the_model_module_names_the_ports_parameters():
    assert all(hasattr(histogan, part) for part in spec.MODEL_PARTS)
    cell = spec.cell(CELL)
    assert cell.model is histogan and cell.config["reduced"] == []
    from palette_and_histo_gan_tpu_torch.models.histogan import Discriminator, Generator

    cfg = histogan.port_config(cell, {"sampler": 1})
    assert cfg.batch_size == 64 and cfg.resolution == 256 and cfg.projection_widths[0] == 1024
    shapes = histogan.parameter_shapes(cell.config)
    with torch.device("meta"):
        nets = {"generator": Generator(cfg), "discriminator": Discriminator(cfg)}
    for net, module in nets.items():
        held = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        assert held == {name: tuple(shape) for name, shape, *_ in shapes[net]}
    counts = {net: sum(torch.Size(s).numel() for _, s, *_ in items)
              for net, items in shapes.items()}
    assert 30e6 < counts["generator"] < 40e6 and 20e6 < counts["discriminator"] < 35e6


@pytest.mark.parametrize("fault,correct", [(None, True), ("half_batch", False)])
def test_the_cell_on_the_cpu(fault, correct, tmp_path):
    proc, result = run_cell(CELL, NARROW, tmp_path, fault, trace=0 if fault else 1)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert result["correct"] is correct, result["checks"]
    if not fault:
        assert result["metrics"]["step.mfu"]["value"] > 0
        # on the CPU the spans record no events and no kernel runs on a card
        assert not set(NEW_METRICS) & set(result["metrics"])


def test_the_flop_count_is_flop_counters_over_one_period():
    """One lazy period (16 steps: Gmain, Dmain each, Greg at 0, 4, 8, 12 on
    half the batch, Dreg at 0) of the reference under FlopCounterMode."""
    from torch.utils.flop_counter import FlopCounterMode

    cell = spec.cell(CELL)
    cell.config["settings"].update(NARROW["settings"])
    traffic = dict(cell.traffic, batch_size=8)
    s = cell.config["settings"]
    gen = torch.Generator().manual_seed(1)
    images = torch.randint(0, 256, (16, 3, 32, 32), generator=gen, dtype=torch.uint8)
    w = weights_gen.draw(histogan.parameter_shapes(cell.config), 2, "cpu")
    seeds = {"sampler": 3, "dropout": 5}
    with FlopCounterMode(display=False) as counter:
        histogan.reference_train(cell.config, traffic, w, (images,), seeds, 16, "float32")
    assert counter.get_total_flops() == histogan_flops.flops_per_image(s) * 16 * 8


def test_the_flop_count_at_the_published_widths():
    s = spec.cell(CELL).config["settings"]
    p = histogan_flops.phase_flops(s)
    # one step of 64 images: ~26 TFLOP, 0.39 s at float32's 67 TFLOP/s
    assert 25.9e12 < histogan_flops.flops_per_image(s) * 64 < 26.1e12
    assert p["Gmain"] < p["Dmain"] and p["hist_real"] == 2.0 * 3 * 64 * 64 * 150 * 150


NEW_METRICS = ("histogan.hist_roofline", "histogan.reg_device_ms", "histogan.networks_device_ms",
               "histogan.optimizer_device_ms")


def _reader(name):
    return spec.metric_reader(name)


def test_the_new_metrics_read_nothing_without_their_sources():
    """A view of a run whose program opens no "PL"/"R1" spans and has no
    histogram groups (the parent's, or a pix2pix cell's) reads None."""
    cell = spec.cell(CELL)
    view = types.SimpleNamespace(cell=cell, steps=16, world=1, start=0, end=1,
                                 groups=lambda: {}, images=16 * 64)
    for name in NEW_METRICS:
        assert _reader(name).read(view) is None, name
    pix2pix = types.SimpleNamespace(cell=spec.cell("histogram.b1024-f32"), steps=25, world=1,
                                    start=0, end=1,
                                    groups=lambda: {"hist-fwd": 1.0, "G-fwd": 1.0, "D-fwd": 1.0})
    for name in NEW_METRICS:
        assert _reader(name).read(pix2pix) is None, name
    bench = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
    new = [m for m in bench["per_layer"] if m["name"].startswith("histogan.")]
    assert sorted(m["name"] for m in new) == sorted(NEW_METRICS)
    assert all(m["workloads"] == [CELL] for m in new)
