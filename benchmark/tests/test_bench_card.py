"""On the card: the control (the reference in the precision below the
configuration's, in the program's place) at each one-chip cell's own size
on three seeds comes out not correct against the cell's limits. Skips
without a card; calibrate.py makes the same readings on more seeds."""

import pytest
import torch

from benchmark.counts import traffic as traffic_gen
from benchmark.counts import weights as weights_gen
from benchmark.harness import spec
from benchmark.reference import compare

CELLS = [w["name"] for w in spec.benchmark()["workloads"] if w["chips"] == 1]


@pytest.mark.card
@pytest.mark.parametrize("cell_name", CELLS)
def test_control_fails_at_the_cells_size(cell_name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cell = spec.cell(cell_name)
    model = cell.model
    control = "tf32" if cell.dtype == "float32" else "fp8"
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        seeds = traffic_gen.sub_seeds(seed)
        data = model.make_splits(cell.config, cell.traffic, seeds["data"], "cuda")
        w = weights_gen.draw(model.parameter_shapes(cell.config), seeds["weights"], "cuda")
        ref = model.reference_train(cell.config, cell.traffic, w, data["train"], seeds, 3,
                                    "float32")
        ctrl = model.reference_train(cell.config, cell.traffic, w, data["train"], seeds, 3,
                                     control)
        ok, checks = compare.judge(compare.numbers(ctrl, ref), cell.limits)
        assert not ok, (seed, checks)
