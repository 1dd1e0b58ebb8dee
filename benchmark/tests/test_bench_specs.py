"""BENCHMARK.json against the rules it is written to, and every file it
names found by name."""

import json
import os
import re

import pytest

from benchmark.harness import spec
from benchmark.tests.conftest import checkout_copy

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) <= 64 * 1024
    cells = len(BENCH["workloads"])
    # 2 + 14 runs a cell, each run_seconds + 60 s and 2 x 90 s a cell, 1200 s spare, at 24 cells
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(kind):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}[kind]
    names = [e["name"] for e in BENCH[kind]]
    assert len(set(names)) == len(names)
    for e in BENCH[kind]:
        assert set(e) <= keys, e
        assert NAME.match(e["name"]), e["name"]
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        if kind in ("end_to_end", "per_layer"):
            assert e["source"] in SOURCES


def test_cells_and_configs():
    configs = {c["name"]: c for c in BENCH["configs"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    files = [c["file"] for c in configs.values()]
    assert len(set(files)) == len(files)
    for c in configs.values():
        assert c["file"].startswith("benchmark/") and c["reduced"] == []
        data = spec.read_json(os.path.join(spec.ROOT, c["file"]))
        assert data["source"] == c["source"] and data["reduced"] == c["reduced"]


@pytest.mark.parametrize("model,message", [
    (None, "no \"model\""), ("no_such_model", "there is no benchmark/models/no_such_model.py"),
    ("../pix2pix", "no \"model\""), ("__init__", "lacks make_splits")])
def test_a_configuration_names_a_model_module(model, message, tmp_path):
    """A configuration without "model", or naming no module of models/ or
    one that lacks a part, stops the run with a message that names the
    configuration's file."""
    dst = checkout_copy(tmp_path)
    path = dst / "benchmark/configs/histogram.json"
    config = json.loads(path.read_text())
    config.pop("model")
    if model is not None:
        config["model"] = model
    path.write_text(json.dumps(config))
    with pytest.raises(SystemExit) as stop:
        spec.cell("histogram.b1024-f32", root=str(dst), bench_dir=str(dst / "benchmark"))
    assert "benchmark/configs/histogram.json" in str(stop.value)
    assert message in str(stop.value)


def test_end_to_end_bounds():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(cell):
    c = spec.cell(cell)
    model = c.model
    assert all(hasattr(model, part) for part in spec.MODEL_PARTS)
    assert c.traffic["entry"] in ("chunk", "dp_chunk")
    entry = spec.entry(c.traffic["entry"])
    for fn in ("setup", "warm", "window", "free"):
        assert callable(getattr(entry, fn))
    assert {"loss_gap", "grad_gap", "change_gap", "nonfinite"} <= set(c.limits)
    assert c.limits["nonfinite"]["limit"] == 0
    assert any(m["name"] == "setup_s" for m in c.end_to_end) and len(c.end_to_end) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    ends = {m["name"] for m in c.end_to_end}
    assert all(m["moves"] in ends for m in c.per_layer)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_reader_loads_by_name(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    reader = spec.metric_reader(metric)
    assert (reader.UNIT, reader.BETTER, reader.LAYER) == (entry["unit"], entry["better"],
                                                        entry["layer"])
    assert callable(reader.read)
    if metric.endswith("_roofline") or "mfu" in metric.split("."):
        assert entry["unit"] == "%"


def test_every_metric_file_declares_its_unit_direction_and_layer():
    names = sorted(f[:-3] for f in os.listdir(os.path.join(spec.BENCH_DIR, "metrics"))
                   if f.endswith(".py"))
    assert set(m["name"] for m in BENCH["per_layer"]) <= set(names)
    for name in names:
        reader = spec.metric_reader(name)
        assert UNIT.match(reader.UNIT) and reader.BETTER in ("lower", "higher")
        assert 1 <= len(reader.LAYER) <= 200 and callable(reader.read)


def test_limits_carry_their_readings():
    names = [f[:-5] for f in os.listdir(os.path.join(spec.BENCH_DIR, "limits"))]
    assert {w["name"] for w in BENCH["workloads"]} <= set(names)
    for cell in names:
        limits = spec.data_file("limits", cell)
        for number in ("loss_gap", "grad_gap", "change_gap"):
            entry = limits[number]
            assert entry["lower"] < entry["limit"] < entry["upper"], (cell, number, entry)
