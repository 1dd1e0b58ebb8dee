"""The port's benchmark (`palette_and_histo_gan_tpu_torch/bench.py`) on the
CPU: with `--device cpu`, a small batch and 2 steps (narrow widths), its
one JSON line has the keys of the repository's `bench.py` record, with
`vs_baseline` null and the host clock; without a card it exits with a
message.
"""

import ast
import functools
import json
import os

import pytest
import torch

from palette_and_histo_gan_tpu_torch import bench, sweep
from palette_and_histo_gan_tpu_torch import config as tconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(down_filters=(8,) * 6, up_filters=(8,) * 6)


def bench_record_keys() -> set:
    """The keys of the dict literal bound to `record` in bench.py."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) and any(
                getattr(t, "id", "") == "record" for t in node.targets):
            return {k.value for k in node.value.keys}
    raise AssertionError("bench.py binds no record")


def test_record_has_the_keys_of_bench_py(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sweep, "config_for_variant",
                        functools.partial(tconfig.config_for_variant, **NARROW))
    for name, value in (("BATCH", "2"), ("STEPS", "2"), ("DTYPE", "float32")):
        monkeypatch.setenv(f"PHG_BENCH_{name}", value)
    assert bench.main(["--device", "cpu"]) == 0
    first, line = capsys.readouterr().out.strip().splitlines()
    record = json.loads(line)
    assert first == "cpu: no card"
    assert set(record) == bench_record_keys()
    assert record["vs_baseline"] is None and record["mfu"] is None
    assert record["clock"] == "host" and record["unit"] == "images/sec/chip"
    assert "batch 2, float32" in record["metric"] and record["value"] > 0
    assert record["flops_per_image"] > 0
    written = json.loads((tmp_path / "build" / "bench.json").read_text())
    assert {k: written[k] for k in record} == record


def test_an_error_row_raises(monkeypatch):
    monkeypatch.setattr(sweep, "measure_variant", lambda *a, **k: {"error": "out of memory"})
    with pytest.raises(RuntimeError, match="out of memory"):
        bench.run(4, 2, "float32", "cpu")


def test_without_a_card_the_command_exits_with_a_message():
    assert not torch.cuda.is_available()
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench.main([])
