"""The span recorder (`utils/tracing.py`) in the train step, the gradient
exchange and the Trainer, at narrow widths on the CPU:

* off, a span is the shared null context: no record, no profiler range,
  no memory kept over 20,000 spans;
* a histogram and an indexed chunk give the same losses and parameters,
  bit for bit, with tracing on and off;
* under a CPU profiler each span but the step has a range of its name,
  in the same order, its host interval within 1 ms of the range's at both
  ends; the records nest step > layer and carry their step's id;
* `enable()` without a profiler records the spans and opens no range;
* the frozen attribution (`benchmark/counts/attribution.py`) puts as many
  aten ops of a step in each group as it did before the recorder, when the
  step had only its forward ranges (counts read on that tree, pinned);
* rank 0 of two in one process (the collectives patched to leave the
  tensor as it is): one step exchanges exactly two gradient all_reduces of
  4 x (G's + D's parameters) bytes, counted by
  `parallel/mesh.py::collectives`, which the "allreduce" span's "bytes"
  reads; the histogram variant at full width exchanges 117,231,376 +
  36,868 bytes;
* the Trainer's phases are spans; a traced fit folds and drops its records
  after each chunk and at its end, keeps its phase_seconds keys and prints
  a "Step breakdown" line with the step's spans and the phases, and `cli
  --trace` prints it too.
"""

import collections
import threading
import tracemalloc

import pytest
import torch
from threadpoolctl import threadpool_limits

from benchmark.counts.attribution import Attribution
from palette_and_histo_gan_tpu_torch import cli
from palette_and_histo_gan_tpu_torch.config import config_for_variant
from palette_and_histo_gan_tpu_torch.models.networks import build_discriminator, build_generator
from palette_and_histo_gan_tpu_torch.parallel import mesh
from palette_and_histo_gan_tpu_torch.parallel.dp import make_dp_train_step
from palette_and_histo_gan_tpu_torch.sweep import prepare
from palette_and_histo_gan_tpu_torch.train.state import create_train_state, param_count
from palette_and_histo_gan_tpu_torch.utils import tracing
from tests.test_torch_lifecycle import NARROW_FLAGS, narrow_trainer

NARROW = dict(down_filters=(8,) * 6, up_filters=(8,) * 6)
LAYERS = {"histogram": {"batch-gather", "augment", "G-fwd", "D-fwd", "hist-fwd", "loss",
                        "G-bwd", "D-bwd", "optimizer"},
          "indexed": {"batch-gather", "G-fwd", "D-fwd", "loss", "G-bwd", "D-bwd", "optimizer"}}
# aten ops a narrow b2 float32 step puts in each group of the frozen
# attribution, read under the tree whose steps opened only the forward
# ranges (train/steps.py::named_range), counted again once the networks ran
# their k4 s2 transposed convolutions as forward convolutions
# (models/networks.py::conv_transpose_k4s2: the weight's phase layout and
# the interleave) and the generator's decoder NHWC (its layout copies; the
# up blocks' NHWC weight gradients copied into the contiguous parameters'
# strides, unattributed as the down blocks' are)
OPS_BY_GROUP = {
    "histogram": {"D-bwd": 183, "D-fwd": 171, "G-bwd": 1015, "G-fwd": 668, "augment": 652,
                  "batch-gather": 26, "hist-bwd": 719, "hist-fwd": 596, "loss": 173,
                  "loss-bwd": 79, "optimizer": 975, "unattributed": 87},
    "indexed": {"D-bwd": 52, "D-fwd": 116, "G-bwd": 1009, "G-fwd": 666, "batch-gather": 36,
                "loss": 324, "loss-bwd": 136, "optimizer": 975, "unattributed": 80},
}


@pytest.fixture(autouse=True)
def one_thread_and_off():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(threads)
        tracing.enable(False)
        tracing.clear()


def _no_range(name):
    raise AssertionError(f"a range opened for {name!r}")


def _setup(variant):
    setup = prepare(variant, 2, "float32", "cpu", **NARROW)
    setup.run(1)
    return setup


def _profiled(run):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    return prof


def test_off_a_span_is_the_shared_null_context(monkeypatch):
    monkeypatch.setattr(tracing, "record_function", _no_range)
    first, second = tracing.span("G-fwd"), tracing.span("allreduce", bytes=4)
    assert first is second
    with first as record:
        assert record is None

    def spans(n):
        for _ in range(n):
            with tracing.span("G-fwd"):
                pass
            with tracing.span("allreduce", bytes=4):
                pass

    spans(100)
    tracemalloc.start()
    try:
        before, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        spans(10000)
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert after == before and peak - before < 1024
    _setup("histogram").run(1)
    assert tracing.records() == []


@pytest.mark.parametrize("variant", ["histogram", "indexed"])
def test_a_step_is_the_same_with_tracing_on_and_off(variant):
    runs = []
    for on in (False, True):
        with torch.backends.mkldnn.flags(enabled=False):
            setup = _setup(variant)
            tracing.enable(on)
            metrics = setup.run(2)
            tracing.enable(False)
        runs.append((metrics, setup.state.state_dict()))
    assert {s.name for s in tracing.records()} >= LAYERS[variant] | {"step"}
    (m_off, s_off), (m_on, s_on) = runs
    assert m_off.keys() == m_on.keys()
    for k in m_off:
        assert torch.equal(m_off[k], m_on[k]), k
    for net in ("generator", "discriminator"):
        for k, v in s_off[net].items():
            assert torch.equal(v, s_on[net][k]), (net, k)


def _check_nesting(spans, variant):
    by_id = {s.id: s for s in spans}
    steps = [s for s in spans if s.name == "step"]
    assert steps and all(s.parent is None and s.step == s.id for s in steps)
    layers = [s for s in spans if s.name != "step"]
    # the chunk's mean of the metrics over the steps, after them
    assert [s.name for s in layers if s.parent is None] == ["loss"]
    assert all(s.step is None and s.start_ns > steps[-1].end_ns
               for s in layers if s.parent is None)
    for s in layers:
        if s.parent is None:
            continue
        parent = by_id[s.parent]
        assert parent.name == "step" and s.step == parent.id, s.name
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    assert {s.name for s in layers if s.step is not None} == LAYERS[variant]
    g_bwd = [s for s in layers if s.name == "G-bwd"]
    assert all(s.start_ns < s.marks["G-out"][0] < s.end_ns for s in g_bwd)


@pytest.mark.parametrize("variant", ["histogram", "indexed"])
def test_spans_are_the_profiler_ranges_on_its_clock(variant):
    setup = _setup(variant)
    prof = _profiled(lambda: setup.run(2))
    spans = tracing.records()
    assert spans and all(s.events is None for s in spans)
    names = {s.name for s in spans}
    ranges = sorted(
        (e for e in prof.profiler.kineto_results.events()
         if e.is_user_annotation() and e.name() in names),
        key=lambda e: e.start_ns())
    # a step opens no range: the layers are the outermost rows in it
    ranged = [s for s in spans if s.name != "step"]
    assert [e.name() for e in ranges] == [s.name for s in ranged]
    for e, s in zip(ranges, ranged):
        assert abs(e.start_ns() - s.start_ns) < 1e6, s.name
        assert abs(e.start_ns() + e.duration_ns() - s.end_ns) < 1e6, s.name
    _check_nesting(spans, variant)


def test_enable_records_without_a_profiler_and_opens_no_range(monkeypatch):
    setup = _setup("indexed")
    monkeypatch.setattr(tracing, "record_function", _no_range)
    tracing.enable()
    setup.run(3)
    spans = tracing.records()
    assert sum(s.name == "step" for s in spans) == 3
    _check_nesting(spans, "indexed")
    totals = tracing.step_totals(spans)
    assert totals["step"]["count"] == 3 and totals["G-bwd to G-out"]["count"] == 3
    assert all(t["device_ms"] is None and t["host_ms"] > 0 for t in totals.values())
    # a span opened on another thread has its own parents
    seen = []

    def other():
        with tracing.span("elsewhere") as record:
            seen.append(record.parent)

    with tracing.span("outer"):
        worker = threading.Thread(target=other)
        worker.start()
        worker.join(timeout=30)
    assert not worker.is_alive() and seen == [None]


@pytest.mark.parametrize("variant", ["histogram", "indexed"])
def test_the_attribution_groups_a_steps_ops_as_before(variant):
    setup = _setup(variant)
    prof = _profiled(lambda: setup.run(1))
    attribution = Attribution(prof)
    ops = collections.Counter(attribution.group_of_op(e) for e in attribution.cpu
                              if e.name.startswith("aten::"))
    assert dict(ops) == OPS_BY_GROUP[variant]


@pytest.mark.parametrize("variant", ["baseline-no-aug", "histogram"])
def test_a_data_parallel_step_exchanges_each_parameter_once(monkeypatch, variant):
    # rank 0 of two, alone: each collective leaves its tensor as it is
    monkeypatch.setattr(mesh.dist, "all_reduce", lambda t: t)
    monkeypatch.setattr(mesh.dist, "broadcast", lambda t, src: t)
    config = config_for_variant(variant, batch_size=4, **NARROW)
    state = create_train_state(config, "cpu", 0)
    params = param_count(state.generator) + param_count(state.discriminator)
    group = mesh.DataGroup(2, 0, torch.device("cpu"))
    g = torch.Generator().manual_seed(5)
    batch = tuple(torch.randint(0, 256, (4, 64, 64, 4), generator=g, dtype=torch.uint8)
                  for _ in range(2))
    mesh.reset_collectives()
    # the state's replication: each network's parameters and moments, the
    # step counts, the two generators' states
    mesh.replicate_state(group, state)
    assert mesh.collectives["broadcast"]["calls"] == 4
    assert mesh.collectives["broadcast"]["bytes"] > 12 * params
    assert mesh.collectives["all_reduce"] == {"calls": 0, "bytes": 0}
    step = make_dp_train_step(config, group)
    tracing.enable()
    metrics = step(state, *mesh.shard_batch(group, batch))
    tracing.enable(False)
    exchanges = [s for s in tracing.records() if s.name == "allreduce"]
    assert [s.attrs for s in exchanges] == [{"bytes": 4 * params}]
    # the two networks' gradients, the step's metrics (one float32 each) and,
    # histogram, the Hellinger loss's sum over the ranks (its backward
    # exchanges nothing)
    hellinger = 1 if variant == "histogram" else 0
    assert mesh.collectives["all_reduce"] == {
        "calls": 3 + hellinger, "bytes": 4 * (params + len(metrics) + hellinger)}


def test_the_histogram_exchange_is_117268244_bytes_at_full_width():
    config = config_for_variant("histogram")
    with torch.device("meta"):
        nets = (build_generator(config, torch.float32), build_discriminator(config, torch.float32))
    assert [(len(list(m.parameters())), 4 * param_count(m)) for m in nets] == [
        (36, 117_231_376), (3, 36_868)]


def test_collectives_count_calls_and_bytes(monkeypatch):
    mesh.reset_collectives()
    monkeypatch.setattr(mesh.dist, "all_reduce", lambda t: t)
    monkeypatch.setattr(mesh.dist, "broadcast", lambda t, src: t)
    group = mesh.DataGroup(2, 0, torch.device("cpu"))
    tensors = [torch.ones(3), torch.ones(2, 2)]
    group.all_reduce_mean_(tensors)
    group.all_reduce_mean_([])
    group.broadcast_([torch.zeros(5, dtype=torch.float64)])
    group.barrier()
    assert mesh.collectives == {"all_reduce": {"calls": 2, "bytes": 32},
                                "broadcast": {"calls": 1, "bytes": 40}}
    assert torch.equal(tensors[0], torch.full((3,), 0.5))
    mesh.reset_collectives()
    assert mesh.collectives == {"all_reduce": {"calls": 0, "bytes": 0},
                                "broadcast": {"calls": 0, "bytes": 0}}


def test_a_traced_fit_folds_its_spans_after_each_chunk(tmp_path, monkeypatch, capsys):
    keys = []
    for on in (False, True):
        trainer = narrow_trainer("histogram", tmp_path / str(on), histogram_impl="pallas2")
        cleared = []
        real_clear = tracing.clear

        def clear(real=real_clear, seen=cleared):
            seen.append([s.name for s in tracing.records()])
            real()

        monkeypatch.setattr(tracing, "clear", clear)
        tracing.enable(on)
        trainer.fit(4, 2, callbacks=["evaluate_l1"])
        tracing.enable(False)
        keys.append(set(trainer.phase_seconds))
        out = capsys.readouterr().out
        assert ("Step breakdown" in out) is on
    assert keys[0] == keys[1] == {"train_chunk", "scalar_logging", "preview", "evaluate_l1",
                                  "checkpoint"}
    # after each chunk's fetch, then the phases after the last one
    assert len(cleared) == 3
    for names in cleared[:2]:  # one chunk's records each
        assert names.count("step") == 2 and names.count("train_chunk") == 1
    assert "step" not in cleared[2] and cleared[2][-1] == "checkpoint"
    assert tracing.records() == []
    assert trainer.step_spans["step"]["count"] == 4
    assert {k: t["count"] for k, t in trainer.phase_spans.items()} == {
        "preview": 3, "train_chunk": 2, "scalar_logging": 2, "evaluate_l1": 3,
        "checkpoint": 2}
    line = next(x for x in out.splitlines() if x.startswith("Step breakdown"))
    assert "G-bwd to G-out - / " in line and "hist-fwd - / " in line
    assert "; phases (ms in all, device / host): " in line and "checkpoint - / " in line


def test_cli_trace_prints_a_step_breakdown(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    common = ["--model", "indexed", "--batch-size", "2", "--device", "cpu", "--synthetic",
              "--dataset-sizes", "20", "--steps", "2", "--update-steps", "1", *NARROW_FLAGS]
    assert cli.main(common) == 0
    assert "Step breakdown" not in capsys.readouterr().out
    assert cli.main([*common, "--trace"]) == 0
    out = capsys.readouterr().out
    assert "Step breakdown (ms a step, device / host): step - / " in out
    assert not tracing._enabled  # the flag ends with the run
