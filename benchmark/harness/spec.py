"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration (configs/<config>.json) and a traffic mix
(traffic/<traffic>.json); the configuration names its model
(models/<model>.py) under "model"; the traffic names the program's entry
point (entries/<entry>.py); the cell's limits are limits/<cell>.json; a
per-layer metric is metrics/<metric>.py. Adding any of them adds files
and entries of BENCHMARK.json and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import types

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
# what the harness asks of a model (models/__init__.py)
MODEL_PARTS = ("make_splits", "parameter_shapes", "reference_train", "flops_per_image",
               "port_config", "load_state", "networks", "losses_of", "plant_half_batch",
               "RANGES")


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return read_json(os.path.join(root, "BENCHMARK.json"))


def data_file(kind: str, name: str, bench_dir: str = BENCH_DIR) -> dict:
    return read_json(os.path.join(bench_dir, kind, f"{name}.json"))


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """metrics/<name>.py as a module: UNIT, BETTER, LAYER and read(view)."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def entry(name: str):
    """entries/<name>.py: setup, first_steps, warm, window, free."""
    return importlib.import_module(f"benchmark.entries.{name}")


def model(cell: Cell) -> types.ModuleType:
    """models/<model>.py of the cell's configuration, which names it under
    "model": everything the harness asks of one model (models/__init__.py).
    A configuration without the key, or naming no such module, stops the
    run with a message that names the configuration's file."""
    name = cell.config.get("model")
    if not isinstance(name, str) or not name.isidentifier():
        raise SystemExit(f"{cell.config_file}: no \"model\" naming a module of "
                         f"benchmark/models/ (it has {name!r})")
    if importlib.util.find_spec(f"benchmark.models.{name}") is None:
        raise SystemExit(f"{cell.config_file}: \"model\": {name!r}, but there is no "
                         f"benchmark/models/{name}.py")
    module = importlib.import_module(f"benchmark.models.{name}")
    missing = [part for part in MODEL_PARTS if not hasattr(module, part)]
    if missing:
        raise SystemExit(f"benchmark/models/{name}.py (named by {cell.config_file}) lacks "
                         f"{', '.join(missing)}")
    return module


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_file: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    model: types.ModuleType | None = None  # models/<model>.py, set by cell()

    @property
    def dtype(self) -> str:
        return self.traffic["compute_dtype"]


def cell(name: str, root: str = ROOT, bench_dir: str = BENCH_DIR) -> Cell:
    bench = benchmark(root)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; it has "
                         f"{[w['name'] for w in bench['workloads']]}")
    w = found[0]
    config_file = next(c["file"] for c in bench["configs"] if c["name"] == w["config"])
    c = Cell(
        name=name, chips=w["chips"], config_file=config_file,
        config=read_json(os.path.join(root, config_file)),
        traffic=data_file("traffic", w["traffic"], bench_dir),
        limits=data_file("limits", name, bench_dir),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)],
    )
    c.model = model(c)
    return c
