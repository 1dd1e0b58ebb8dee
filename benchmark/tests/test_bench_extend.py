"""A later change adds a cell, a configuration, a traffic mix and a
per-layer metric by adding files and BENCHMARK.json entries, editing no
file that is there: a throwaway cell built so in a copy of the benchmark
runs, with its new metric, and every file of the copy that was there is
unchanged. Also: a run exits non-zero without a result line where the
program is missing, and where no card is present."""

import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.counts.peaks import PEAK
from benchmark.tests.conftest import ROOT, TINY, checkout_copy
from benchmark.tests.test_bench_faults import run_cell

NEW_METRIC = '''"""Host seconds a step in the "G-fwd" range."""

UNIT, BETTER, LAYER = "ms", "lower", "generator forward (models/networks.py)"


def read(view):
    seconds = view.host_seconds("G-fwd")
    return 1e3 * seconds / view.steps if seconds and view.steps else None
'''


def _copy(tmp_path):
    return checkout_copy(tmp_path / "checkout")


def _digests(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            path = os.path.join(base, f)
            out[os.path.relpath(path, root)] = hashlib.sha256(open(path, "rb").read()).hexdigest()
    return out


def test_a_cell_config_traffic_and_metric_added_by_files_alone(tmp_path):
    dst = _copy(tmp_path)
    before = _digests(dst)
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    config = json.loads((dst / "benchmark/configs/histogram.json").read_text())
    config["variant"] = "baseline"
    config["settings"]["lambda_l1"] = 100.0
    (dst / "benchmark/configs/baseline.json").write_text(json.dumps(config))
    mix = json.loads((dst / "benchmark/traffic/b1024-f32.json").read_text())
    mix["steps_per_chunk"] = 5
    (dst / "benchmark/traffic/b1024-f32-c5.json").write_text(json.dumps(mix))
    limits = (dst / "benchmark/limits/histogram.b1024-f32.json").read_text()
    (dst / "benchmark/limits/baseline.b1024-f32-c5.json").write_text(limits)
    (dst / "benchmark/metrics/gfwd.host_ms.py").write_text(NEW_METRIC)
    bench["configs"].append({"name": "baseline", "source": config["source"],
                             "file": "benchmark/configs/baseline.json", "reduced": [],
                             "why": "a throwaway configuration"})
    bench["workloads"].append({"name": "baseline.b1024-f32-c5", "config": "baseline",
                               "traffic": "b1024-f32-c5", "chips": 1, "why": "a throwaway cell"})
    bench["per_layer"].append({"name": "gfwd.host_ms", "unit": "ms", "better": "lower",
                               "source": "program_span",
                               "layer": "generator forward (models/networks.py)",
                               "moves": "train_img_per_s",
                               "workloads": ["baseline.b1024-f32-c5"]})
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(dst)
    changed = [k for k, v in before.items() if after[k] != v and k != "BENCHMARK.json"]
    assert not changed
    proc, result = run_cell("baseline.b1024-f32-c5", TINY, tmp_path, trace=1, cwd=str(dst),
                            env={"PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert result["correct"] is True, result["checks"]
    assert result["metrics"]["gfwd.host_ms"]["value"] > 0
    assert "augment" not in proc.stdout.split("launches a step:")[1].split(";")[0]


TOY = os.path.join(ROOT, "benchmark", "tests", "toy")


def _load(path):
    spec = importlib.util.spec_from_file_location("toy_model", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("fault,correct", [(None, True), ("half_batch", False)])
def test_another_model_added_by_files_alone(fault, correct, tmp_path):
    """The toy model (tests/toy/: its configuration, model module, entry,
    traffic and limits) added to a copy as new files and BENCHMARK.json
    entries: a run of its cell is correct, refuses the half-batch fault
    the model plants, and reads step.mfu from the model's own count."""
    dst = _copy(tmp_path)
    before = _digests(dst)
    added = [os.path.relpath(os.path.join(base, f), TOY)
             for base, _, files in os.walk(TOY) for f in files if not f.endswith(".pyc")]
    for rel in added:
        assert not (dst / "benchmark" / rel).exists(), rel
        (dst / "benchmark" / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(os.path.join(TOY, rel), dst / "benchmark" / rel)
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    config = json.loads((dst / "benchmark/configs/toy.json").read_text())
    bench["configs"].append({"name": "toy", "source": config["source"],
                             "file": "benchmark/configs/toy.json", "reduced": [],
                             "why": "a throwaway model"})
    bench["workloads"].append({"name": "toy.toy-b8", "config": "toy", "traffic": "toy-b8",
                               "chips": 1, "why": "a throwaway cell"})
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(dst)
    assert not [k for k, v in before.items() if after[k] != v and k != "BENCHMARK.json"]
    proc, result = run_cell("toy.toy-b8", {}, tmp_path, fault, trace=1, cwd=str(dst),
                            env={"PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert result["correct"] is correct, result["checks"]
    if fault:
        return
    mix = json.loads((dst / "benchmark/traffic/toy-b8.json").read_text())
    images = mix["trace_chunks"] * mix["steps_per_chunk"] * mix["batch_size"]
    per_image = _load(dst / "benchmark/models/toy.py").flops_per_image(config)
    expected = 100.0 * per_image * images / (result["device"]["window_s"] * PEAK["float32"])
    assert result["metrics"]["step.mfu"]["value"] == pytest.approx(expected, rel=1e-12)


def test_no_result_without_the_program(tmp_path):
    dst = _copy(tmp_path)
    proc, result = run_cell("histogram.b1024-f32", TINY, tmp_path, cwd=str(dst),
                            env={"PYTHONPATH": ""})
    assert proc.returncode != 0 and result is None
    assert "{" not in proc.stdout


def test_no_result_without_a_card(tmp_path):
    env = dict(os.environ, TMPDIR=str(tmp_path), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
                           "--workload", "histogram.b1024-f32", "--seed", "1", "--seconds",
                           "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


def test_the_import_guard_compares_whole_top_level_names(monkeypatch):
    from benchmark.harness import guard

    monkeypatch.setitem(sys.modules, "palette_and_histo_gan_tpu_torch_fake", object())
    assert guard.loaded() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert guard.loaded() == ["jaxlib"]


JAX_METRIC = '''"""A reader that loads a module named jax when it runs."""

import sys
import types

UNIT, BETTER, LAYER = "ms", "lower", "a layer"


def read(view):
    sys.modules["jax"] = types.ModuleType("jax")
    return 1.0
'''


def test_no_result_when_a_metric_reader_loads_jax_after_the_window(tmp_path):
    """The guard's last look comes after the reference and the metric
    readers: a reader that loads JAX leaves the run without a result."""
    metric = {"name": "loads.jax", "unit": "ms", "better": "lower", "source": "program_span",
              "layer": "a layer", "moves": "train_img_per_s",
              "workloads": ["histogram.b1024-f32"]}
    dst = checkout_copy(tmp_path / "checkout", metrics=[metric])
    (dst / "benchmark/metrics/loads.jax.py").write_text(JAX_METRIC)
    proc, result = run_cell("histogram.b1024-f32", TINY, tmp_path, trace=1, cwd=str(dst),
                            env={"PYTHONPATH": ROOT})
    assert proc.returncode != 0 and result is None
    assert '"correct"' not in proc.stdout
    assert "import guard (before the result): jax" in proc.stderr
