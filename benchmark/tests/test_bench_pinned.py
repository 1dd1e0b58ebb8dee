"""The pix2pix cells' yardstick pinned: sha256 digests of the data splits
and the weight draw at the tests' narrow widths from seed 1, and the FLOP
count an image at the published widths, bit for bit; and the reference's
readings from the same draw (each step's losses, the first gradient norms,
the change norms; pinned/<cell>.json) within a small tolerance. A change
that moves the harness's code keeps them; a change of the yardstick itself
is a new benchmark and shows here.

The readings are float32 convolutions, which another PyTorch build or CPU
may sum in another order, so they are compared as `correct` compares them
(reference/compare.py, quiet parameters left out) and not bit for bit.
TOLERANCE is over seven times the widest gap between oneDNN's and
PyTorch's own CPU convolutions, one thread and several (1.4e-7, 1.2e-6 and
2.8e-5), and under the tightest limit of each number in limits/."""

import hashlib
import json
import os

import pytest
import torch

from benchmark.counts import traffic as traffic_gen
from benchmark.counts import weights as weights_gen
from benchmark.harness import core, spec
from benchmark.reference import compare
from benchmark.tests.conftest import TINY

PINNED = {
    "histogram.b1024-f32": {
        "splits": "c9d43ef4e94edeb594605c0dc992d8eac173e46e61e26d1de88aee0058e942e7",
        "weights": "0d5ff26a3d6943c4da7d7a64c9797a503c9d999b380cc0e02075aacfef6c3d5a",
        "flops_per_image": 3114270720.0,
    },
    "indexed.b1024-f32": {
        "splits": "c25c9319fbdcb3ead7e8ff1aef93a2b04dbb8756b58f0b8d93132a00d8fba1e1",
        "weights": "146fa1172275aea6e75acf04417ebe96865751815e17c027704a724acd362e28",
        "flops_per_image": 5926551552.0,
    },
}
PINNED_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "pinned")
TOLERANCE = {"loss_gap": 1e-6, "grad_gap": 3e-5, "change_gap": 1e-3}


def _tensors_digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().cpu().contiguous()
        h.update(f"{tuple(t.shape)} {t.dtype};".encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


@pytest.fixture
def _quiet_cpu():
    saved = torch.backends.mkldnn.enabled, torch.get_num_threads()
    torch.backends.mkldnn.enabled = False
    torch.set_num_threads(1)
    yield
    torch.backends.mkldnn.enabled = saved[0]
    torch.set_num_threads(saved[1])


@pytest.mark.parametrize("cell_name", sorted(PINNED))
def test_the_yardstick_is_unchanged(cell_name, _quiet_cpu):
    pinned = PINNED[cell_name]
    published = spec.cell(cell_name)
    model = published.model
    assert model.flops_per_image(published.config) == pinned["flops_per_image"]
    cell = core.apply_overrides(spec.cell(cell_name), TINY)
    seeds = traffic_gen.sub_seeds(1)
    data = model.make_splits(cell.config, cell.traffic, seeds["data"], "cpu")
    assert data["test"] is None
    assert _tensors_digest(data["train"]) == pinned["splits"]
    w = weights_gen.draw(model.parameter_shapes(cell.config), seeds["weights"], "cpu")
    names = [f"{net}/{name}" for net in w for name in w[net]]
    assert _tensors_digest([torch.tensor(list(" ".join(names).encode()))]
                           + [t for net in w.values() for t in net.values()]) == pinned["weights"]
    ref = model.reference_train(cell.config, cell.traffic, w, data["train"], seeds,
                                cell.traffic["check_steps"], "float32")
    with open(os.path.join(PINNED_DIR, f"{cell_name}.json")) as f:
        pinned_readings = json.load(f)
    for key in ("grad_norms", "change_norms"):
        assert {net: list(v) for net, v in ref[key].items()} == \
            {net: list(v) for net, v in pinned_readings[key].items()}
    gaps = compare.numbers(ref, pinned_readings)
    assert all(gaps[name] <= limit for name, limit in TOLERANCE.items()), gaps
