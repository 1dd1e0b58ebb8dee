"""The step roofline (`palette_and_histo_gan_tpu_torch/roofline.py`) and the
step's spans (`train/steps.py`, `utils/tracing.py`), at narrow widths on
the CPU:

* a narrow step profiled with its ranges: every op with time lands in a
  group of the roofline's (unattributed under 5% of the time), and every
  op an autograd node ran lands in the -bwd group of its forward op: the
  generator's 13 convolutions' backwards in G-bwd, the discriminator's in
  D-bwd (6 for histogram: its three passes; 2 for indexed: the stacked
  pass), the histogram's backward in hist-bwd;
* the ranges add no aten op to a step apart from the profiler's own range
  ops (a TorchDispatchMode over the step, ranges on and off);
* the tensor-core FLOPs of each group equal
  `scripts/roofline.py::mxu_group_floors`' before its TPU peak, for
  histogram and indexed;
* a group with no count of a kind gets None, never a guess;
* the bytes count: a gather counts its output, a repeated input once, a
  broadcast input its storage;
* `utils/roofline.py::bound` gives K6's 0.0802 ms for its 268.4 MB.
"""

import collections
import contextlib
import os
import sys

import pytest
import torch
from threadpoolctl import threadpool_limits
from torch.utils._python_dispatch import TorchDispatchMode

from palette_and_histo_gan_tpu.config import config_for_variant as jax_config_for_variant
from palette_and_histo_gan_tpu_torch import roofline
from palette_and_histo_gan_tpu_torch.config import config_for_variant
from palette_and_histo_gan_tpu_torch.sweep import prepare
from palette_and_histo_gan_tpu_torch.utils import tracing
from palette_and_histo_gan_tpu_torch.utils.roofline import bound

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

NARROW = dict(down_filters=(8,) * 6, up_filters=(8,) * 6)
GROUPS = set(roofline.RANGES) | {"G-bwd", "D-bwd", "hist-bwd", "loss-bwd"} | set(
    roofline.NO_FLOOR_GROUPS)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def profiles():
    """One profiled narrow b2 float32 step of histogram and of indexed."""
    out = {}
    for variant in ("histogram", "indexed"):
        setup = prepare(variant, 2, "float32", "cpu", **NARROW)
        setup.run(1)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                    record_shapes=True) as prof:
            setup.run(1)
        out[variant] = (prof, roofline.attribute_cpu(prof))
    return out


def _under_autograd(event) -> bool:
    return any(a.name.startswith(roofline.EVALUATE) for a in roofline._ancestors(event))


@pytest.mark.parametrize("variant", ["histogram", "indexed"])
def test_every_op_with_time_lands_in_a_group(profiles, variant):
    _, groups = profiles[variant]
    time = collections.Counter()
    for event, group in groups.items():
        assert group in GROUPS, (event.name, group)
        time[group] += event.self_cpu_time_total
    assert len(groups) > 1000
    assert time["unattributed"] < 0.05 * sum(time.values())
    for group in ("batch-gather", "G-fwd", "D-fwd", "loss", "optimizer", "G-bwd", "D-bwd",
                  "loss-bwd", "copy/layout"):
        assert time[group] > 0, group
    if variant == "histogram":
        assert time["augment"] > 0 and time["hist-fwd"] > 0 and time["hist-bwd"] > 0


@pytest.mark.parametrize("variant", ["histogram", "indexed"])
def test_backward_ops_land_in_the_bwd_group_of_their_forward_op(profiles, variant):
    prof, groups = profiles[variant]
    attribution = roofline.Attribution(prof)
    conv = collections.Counter()
    for event, group in groups.items():
        if not _under_autograd(event):
            assert not group.endswith("-bwd"), (event.name, group)
            continue
        if group in roofline.NO_FLOOR_GROUPS:
            continue
        evaluate = next(a for a in roofline._ancestors(event)
                        if a.name.startswith(roofline.EVALUATE))
        forward = attribution.forward_op(evaluate)
        assert group == roofline.backward_group(attribution.range_of(forward))
        if event.name == "aten::convolution_backward":
            conv[group] += 1
            # the networks' k4 s2 convolutions are autograd Functions
            # (models/networks.py), whose ranges carry their names
            assert forward.name in ("aten::convolution", "aten::conv2d", "aten::conv_transpose2d",
                                    "_ConvK4S2", "_ConvTransposeK4S2")
        if "HistogramCore" in event.name or "FusedHistogram" in event.name:
            assert group == "hist-bwd"
    assert conv == {"G-bwd": 13, "D-bwd": 6 if variant == "histogram" else 2}
    # only the gradients' accumulation has no forward op
    lost = {e.name for e, g in groups.items() if _under_autograd(e) and g == "unattributed"}
    assert all("AccumulateGrad" in n or "detach" in n for n in lost if "evaluate" in n or
               "Accumulate" in n), lost


class Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("variant", ["histogram", "indexed"])
def test_ranges_add_no_op_to_the_step(variant, monkeypatch):
    """Under a profiler, the step with its ranges runs the ops of the step
    without them plus the profiler's own range ops; outside a profile the
    ranges are not entered at all."""
    recorded = {}
    for profiling, ranges in ((True, True), (False, True), (True, False)):
        if not ranges:
            monkeypatch.setattr(tracing, "record_function",
                                lambda name: contextlib.nullcontext())
        setup = prepare(variant, 2, "float32", "cpu", **NARROW)
        scope = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
                 if profiling else contextlib.nullcontext())
        with scope, Ops() as ops:
            setup.run(1)
        recorded[profiling, ranges] = ops.names
    # the optimizers' own "Optimizer.step#" ranges are in every run
    ops = {k: [n for n in v if not n.startswith("profiler.")] for k, v in recorded.items()}
    assert ops[True, True] == ops[True, False] == ops[False, True]
    assert len(ops[True, False]) > 500
    added = len(recorded[True, True]) - len(recorded[True, False])
    assert added > 0 and all(n.startswith("profiler._record_function")
                             for n in recorded[True, True] if n.startswith("profiler."))
    assert recorded[False, True] == recorded[True, False]


@pytest.mark.parametrize("variant", ["histogram", "indexed"])
def test_tensor_core_flops_are_the_jax_roofline_groups(variant):
    import roofline as script

    jax_config = jax_config_for_variant(variant, batch_size=1024)
    want = {k: v * script.MXU_PEAK for k, v in script.mxu_group_floors(jax_config, 1024).items()}
    got = roofline.tensor_core_flops(config_for_variant(variant, batch_size=1024), 1024)
    assert got.keys() == want.keys()
    for group in want:
        assert got[group] == pytest.approx(want[group], rel=1e-12), group


def test_a_group_with_no_count_gets_none():
    config = config_for_variant("histogram", batch_size=1024, compute_dtype="bfloat16")
    measured = {"G-fwd": 9.0, "loss-bwd": 1.0, "copy/layout": 6.0, "unattributed": 0.2,
                "optimizer": 2.0, "hist-fwd": 1.4}
    out = roofline.table(config, measured, {"optimizer": 3.35e9, "copy/layout": 1e9}, 20.0,
                         {"hist-fwd": 0.27})
    rows = {r["group"]: r for r in out["rows"]}
    for group in ("loss-bwd", "copy/layout", "unattributed"):
        r = rows[group]
        assert r["bytes_floor_ms"] is r["tensor_core_floor_ms"] is r["kernel_floor_ms"] is None
        assert r["bound_ms"] is None and r["ratio"] is None
    assert rows["optimizer"]["bytes_floor_ms"] == pytest.approx(1.0)
    assert rows["optimizer"]["tensor_core_floor_ms"] is None
    assert rows["optimizer"]["bound_by"] == "bytes" and rows["optimizer"]["ratio"] == 2.0
    assert rows["G-fwd"]["tensor_core_floor_ms"] > 0 and rows["G-fwd"]["bytes_floor_ms"] is None
    assert rows["hist-fwd"]["bound_ms"] == max(0.27, rows["hist-fwd"]["tensor_core_floor_ms"])
    # the groups the count covers but the profile did not see read 0 ms
    assert rows["G-bwd"]["measured_ms"] == 0.0
    assert out["unattributed_share"] == pytest.approx(0.01)
    assert out["floor_sum_ms"] == pytest.approx(sum(r["bound_ms"] or 0 for r in out["rows"]))


class Event:
    def __init__(self, name, shapes, concrete=None):
        self.name, self.input_shapes = name, shapes
        self.concrete_inputs = concrete or []


def test_op_bytes():
    # the batch gather from a resident pool reads the gathered rows only
    gather = Event("aten::index", [[1024, 4096], [[4]]])
    assert roofline.op_bytes(gather, ["int", "TensorList"], []) == 4 * 4096 * 4
    select = Event("aten::index_select", [[1024, 4096], [], [8]], concrete=["", 0, ""])
    assert roofline.op_bytes(select, ["float", "Scalar", "long int"], []) == 8 * 4096 * 4
    # x * x reads x once; a broadcast view counts its storage
    square = Event("aten::mul", [[64, 64], [64, 64]])
    assert roofline.op_bytes(square, ["float", "float"], [[64, 1], [64, 1]]) == 64 * 64 * 4
    add = Event("aten::add", [[8, 16, 32], [8, 16, 32], []])
    assert roofline.op_bytes(add, ["c10::BFloat16"] * 2 + ["Scalar"],
                             [[512, 32, 1], [0, 0, 1], []]) == 2 * (8 * 16 * 32 + 32)


def test_bound_gives_k6_floor():
    # K6 at (1024, 32, 64, 64) bfloat16: 268.4 MB of input, two (B, C)
    # float32 outputs
    moved = 1024 * 32 * 64 * 64 * 2 + 2 * 1024 * 32 * 4
    ms, by = bound(moved, (3 * 1024 * 32 * 64 * 64, "float32"))
    assert by == "bytes" and round(ms, 4) == 0.0802
    assert round(1024 * 32 * 64 * 64 * 2 / 1e6, 1) == 268.4
