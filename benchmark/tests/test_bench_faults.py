"""Whole runs of the harness on the CPU at narrow widths, past its look for
a card: a sound run comes out correct, and a run with the timed path
broken underneath comes out not correct, once for each fault a cell can
have: a step that returns its state unchanged, half of the batch left out,
and (in the data-parallel cell, two Gloo ranks) the exchange between the
ranks left out; and an optimizer run with another beta1 than the
configuration states."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT, TINY

RUN = os.path.join(ROOT, "benchmark", "run.py")


def run_cell(cell, overrides, tmp_path, fault=None, seed=2**31 + 77, trace=0, cwd=ROOT, env=None):
    args = [sys.executable, RUN if cwd == ROOT else os.path.join(cwd, "benchmark", "run.py"),
            "--workload", cell, "--seed", str(seed), "--seconds", "1", "--trace", str(trace),
            "--test-device", "cpu", "--test-overrides", json.dumps(overrides)]
    if fault:
        args += ["--plant-fault", fault]
    environ = dict(os.environ, TMPDIR=str(tmp_path), OMP_NUM_THREADS="1", **(env or {}))
    proc = subprocess.run(args, cwd=cwd, capture_output=True, text=True, timeout=600, env=environ)
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    return proc, result


# The last item names a number that must fail: the first gradient is decoded
# with the configuration's beta1, so a program that runs another reads 0.2 of
# it in grad_gap, whatever the other numbers read at these widths.
CASES = [
    ("histogram.b1024-f32", TINY, None, True, None),
    ("histogram.b1024-f32", TINY, "unchanged_state", False, None),
    ("histogram.b1024-f32", TINY, "half_batch", False, None),
    ("histogram.b1024-f32", TINY, "wrong_beta1", False, "grad_gap"),
    ("indexed.b1024-f32", TINY, None, True, None),
    ("indexed.b1024-f32", TINY, "unchanged_state", False, None),
    ("indexed.b1024-f32", TINY, "half_batch", False, None),
    ("indexed.b1024-f32", TINY, "wrong_beta1", False, "grad_gap"),
]


@pytest.mark.parametrize("cell,overrides,fault,correct,fails", CASES)
def test_one_chip_cells(cell, overrides, fault, correct, fails, tmp_path):
    proc, result = run_cell(cell, overrides, tmp_path, fault)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert result["correct"] is correct, result["checks"]
    assert list(result)[-1] == "checks"
    assert proc.stderr.strip().splitlines()[-1] == f"correct: {correct}"
    assert not os.listdir(tmp_path) or all(n.startswith("torchinductor") for n in os.listdir(tmp_path))
    if fails:
        assert result["checks"][fails]["value"] > 0.5 > result["checks"][fails]["limit"]


DP = {"settings": TINY["settings"], "traffic": dict(TINY["traffic"], batch_size=8), "chips": 2}


@pytest.mark.parametrize("fault,correct", [(None, True), ("no_exchange", False),
                                           ("half_batch", False)])
def test_data_parallel_cell_over_two_gloo_ranks(fault, correct, tmp_path):
    proc, result = run_cell("histogram.b1024-f32.dp4", DP, tmp_path, fault, trace=1)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert result["correct"] is correct, result["checks"]
    assert result["device"]["count"] == 2
    assert "device.idle_share" in result["metrics"]
