"""The plain reference against the program's own step on the CPU at narrow
widths, from the same weights and seeds, and its independence from the
program."""

import ast
import os
import subprocess
import sys
import types

import pytest
import torch

from benchmark.counts import traffic as traffic_gen
from benchmark.counts import weights as weights_gen
from benchmark.harness import core, program, spec
from benchmark.reference import augment, compare, draws, histogram, nets, step
from benchmark.reference.precision import Precision
from benchmark.tests.conftest import ROOT, TINY

REFERENCE_DIR = os.path.join(ROOT, "benchmark", "reference")


def _program(cell, seed, overrides):
    cell = core.apply_overrides(cell, overrides)
    torch.backends.mkldnn.enabled = False
    seeds = traffic_gen.sub_seeds(seed)
    ctx = types.SimpleNamespace(cell=cell, device=torch.device("cpu"), group=None,
                                seeds=seeds, agree=lambda flag: flag)
    model = cell.model
    ctx.data = model.make_splits(cell.config, cell.traffic, seeds["data"], "cpu")
    ctx.weights = weights_gen.draw(model.parameter_shapes(cell.config), seeds["weights"], "cpu")
    entry = spec.entry(cell.traffic["entry"])
    entry.setup(ctx)
    readings = program.first_readings(cell, ctx.run_chunk, ctx.state, ctx.weights, 3)
    entry.free(ctx)
    ref = step.train(cell.config, cell.traffic,
                     weights_gen.draw(model.parameter_shapes(cell.config), seeds["weights"], "cpu"),
                     ctx.data["train"], seeds, 3)
    return cell, readings, ref


@pytest.fixture(autouse=True)
def _mkldnn():
    saved = torch.backends.mkldnn.enabled
    yield
    torch.backends.mkldnn.enabled = saved


@pytest.mark.parametrize("cell_name", ["histogram.b1024-f32", "indexed.b1024-f32"])
def test_reference_equals_the_programs_float32_steps(cell_name):
    cell, readings, ref = _program(spec.cell(cell_name), 21, TINY)
    values = compare.numbers(readings, ref)
    assert values["loss_gap"] < 1e-5, values
    assert values["grad_gap"] < 1e-4, values
    limits = spec.cell("histogram.b1024-f32").limits
    assert values["change_gap"] < limits["change_gap"]["limit"], values


@pytest.mark.parametrize("cell_name", ["histogram.b1024-f32", "indexed.b1024-f32"])
def test_the_programs_bfloat16_steps_fail_the_float32_limits(cell_name):
    bf16 = {"settings": TINY["settings"], "traffic": dict(TINY["traffic"], compute_dtype="bfloat16")}
    cell, readings, ref = _program(spec.cell(cell_name), 22, bf16)
    ok, checks = compare.judge(compare.numbers(readings, ref),
                               spec.cell("histogram.b1024-f32").limits)
    assert not ok, checks


def test_draws_equal_the_programs():
    from palette_and_histo_gan_tpu_torch.data.loader import batch_indices
    from palette_and_histo_gan_tpu_torch.models.networks import DropoutDraw
    from palette_and_histo_gan_tpu_torch.ops.augment import draw_params

    for step_ in (0, 5, 63, 200):
        assert torch.equal(draws.batch_indices(9, step_, 250, 4, "cpu"),
                           batch_indices(9, step_, 250, 4, "cpu"))
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    ours, theirs = draws.augment_params(g1, 16, 0.8), draw_params(g2, 16, 0.8)
    assert torch.equal(ours[0], theirs[0])
    for a, b in zip(ours[1:], theirs[1:]):
        assert torch.equal(a.long(), b.long())
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    shape = (8, 16, 4, 4)
    assert torch.equal(draws.dropout_keep(g1, shape, 0.5),
                       DropoutDraw(g2).keep_mask(shape, torch.device("cpu")))


def test_augment_equals_the_programs_plain_version():
    from palette_and_histo_gan_tpu_torch.ops.augment import augment_plain, draw_params

    gen = torch.Generator().manual_seed(1)
    src = torch.randint(0, 256, (32, 64, 64, 4), generator=gen, dtype=torch.uint8)
    tgt = torch.randint(0, 256, (32, 64, 64, 4), generator=gen, dtype=torch.uint8)
    d = draw_params(torch.Generator().manual_seed(2), 32, 0.8)
    ours = augment.augment_pair(src, tgt, d[0], d[1].long(), d[2].long(), d[3] != 0)
    theirs = augment_plain(src, tgt, *d, normalize_out=True)
    for a, b in zip(ours, theirs):
        assert float((a - b).abs().max()) < 1e-5


def test_histogram_equals_the_programs_plain_version():
    from palette_and_histo_gan_tpu_torch.ops.histogram import calculate_rgbuv_histogram

    x = torch.rand(6, 64, 64, 4, generator=torch.Generator().manual_seed(5)) * 2 - 1
    ours = histogram.histograms(x, 64, 0.02, Precision(), block=4).permute(0, 2, 3, 1)
    theirs = calculate_rgbuv_histogram(x.double(), dtype=torch.float64)
    assert float((ours.double() - theirs).abs().max() / theirs.abs().max()) < 1e-5
    # the blocked backward against autograd through the whole batch
    other = torch.rand(6, 64, 64, 4, generator=torch.Generator().manual_seed(6)) * 2 - 1
    y = other.clone().requires_grad_(True)
    z = other.clone().requires_grad_(True)
    histogram.hellinger(histogram.histograms(x, 64, 0.02, Precision(), 6),
                        histogram.histograms(y, 64, 0.02, Precision(), 2)).backward()
    histogram.hellinger(histogram._planes(x, 64, 0.02, Precision()),
                        histogram._planes(z, 64, 0.02, Precision())).backward()
    assert float((y.grad - z.grad).abs().max()) <= 1e-6 * float(z.grad.abs().max())


def test_fp8_control_rounds_operands_and_gradients():
    prec = Precision("fp8")
    x = torch.randn(4, 8, 8, 8, requires_grad=True)
    w = torch.randn(8, 8, 4, 4, requires_grad=True)
    y = prec.conv2d(x, w, stride=2, padding=1)
    exact = torch.nn.functional.conv2d(x, w, stride=2, padding=1)
    rel = float((y - exact).abs().max().detach() / exact.abs().max().detach())
    assert 1e-3 < rel < 0.2
    y.sum().backward()
    assert x.grad is not None and w.grad is not None


def test_reference_imports_nothing_of_the_program():
    banned = {"palette_and_histo_gan_tpu_torch", "palette_and_histo_gan_tpu", "jax", "jaxlib",
              "flax"}
    for name in os.listdir(REFERENCE_DIR):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(REFERENCE_DIR, name)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or "").split(".")[0]} if node.level == 0 else set()
            else:
                continue
            assert not tops & banned, (name, tops)
    code = ("import sys; import benchmark.reference.step, benchmark.reference.compare; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True).stdout
    tops = set(eval(out))
    assert not tops & banned, tops & banned


def test_dropout_shapes_are_the_first_three_up_blocks():
    config = spec.data_file("configs", "histogram")
    assert nets.dropout_shapes(config, 2) == [(2, 512, 2, 2), (2, 512, 4, 4), (2, 256, 8, 8)]



def test_a_parameter_the_program_moves_and_the_reference_does_not_is_counted():
    names = [f"p{i}" for i in range(5)]
    ref = {"grad_norms": {"generator": dict(zip(names, [1.0, 1.0, 1.0, 1.0, 0.0]))},
           "change_norms": {"generator": dict(zip(names, [1.0] * 5))}, "losses": [[1.0, 1.0]]}
    quiet = {"grad_norms": {"generator": dict(zip(names, [1.0, 1.0, 1.0, 1.0, 1e-9]))},
             "change_norms": ref["change_norms"], "losses": [[1.0, 1.0]]}
    moved = {"grad_norms": {"generator": dict(zip(names, [1.0, 1.0, 1.0, 1.0, 0.7]))},
             "change_norms": {"generator": dict(zip(names, [1.0, 1.0, 1.0, 1.0, 1.7]))},
             "losses": [[1.0, 1.0]]}
    assert compare.quiet_parameters(quiet, ref) == ["generator/p4"]
    assert compare.numbers(quiet, ref)["grad_gap"] == 0.0
    assert compare.quiet_parameters(moved, ref) == []
    values = compare.numbers(moved, ref)
    assert values["grad_gap"] == pytest.approx(0.7) and values["change_gap"] == pytest.approx(0.7)
    assert compare.reference_quiet(moved, ref) == [["generator/p4", 0.7, 0.0]]
