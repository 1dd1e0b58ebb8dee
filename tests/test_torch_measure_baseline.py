"""The port's measured-baseline protocol
(`palette_and_histo_gan_tpu_torch/measure_baseline.py`) on the CPU, at
narrow widths, one epoch on the first 60 pairs of a synthetic dataset
root: the entry's keys are those of `baseline_results.json`'s entries plus
the port's, its values finite, the FID reports run through the shared
evaluator (the Inception at input 75 here, as tests/test_torch_export.py
sizes it), and without a card the command exits with a message.
"""

import functools
import json
import math
import os

import pytest
import torch
from threadpoolctl import threadpool_limits

from palette_and_histo_gan_tpu_torch import measure_baseline, ref_regime
from palette_and_histo_gan_tpu_torch.eval import fid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# narrow networks on the first 60 pairs of the root (51 train, 9 test): 13
# steps an epoch, each followed by a preview and an L1 report
NARROW = dict(down_filters=(8,) * 6, up_filters=(8,) * 6, dataset_sizes=(60,))
PORT_KEYS = {"data_root", "histogram_impl", "peak_device_memory_bytes", "launches"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread and one BLAS thread while the file runs: the suite
    runs several test processes on the host's cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(threads)


def baseline_entry_keys() -> set:
    with open(os.path.join(REPO, "baseline_results.json")) as f:
        return set(json.load(f)["results"][0])


@pytest.fixture(scope="module")
def entry(tmp_path_factory):
    base = tmp_path_factory.mktemp("baseline")
    root = ref_regime.write_synthetic_root(str(base / "dataset"))
    evaluator = fid.FidEvaluator(device="cpu", input_size=75)
    return measure_baseline.run_variant(
        "histogram", 1, True, evaluator, "cpu", root, temp_folder=str(base / "temp"), **NARROW), root


def test_entry_has_the_keys_of_baseline_results(entry):
    result, _ = entry
    assert set(result) == baseline_entry_keys() | PORT_KEYS


def test_entry_values(entry):
    result, root = entry
    assert result["variant"] == "histogram" and result["architecture"] == "front-to-right"
    assert result["steps"] == 13 and result["batch_size"] == 4
    assert result["steps_per_second"] == pytest.approx(13 / result["train_seconds"])
    for key in ("l1_train", "l1_test", "fid_train", "fid_test"):
        assert math.isfinite(result[key]) and result[key] >= 0, key
    assert result["fid_weights"].startswith("random-init")
    assert {"train_chunk", "preview", "evaluate_l1", "checkpoint"} <= set(result["phase_seconds"])
    assert result["data_root"] == root and result["histogram_impl"] == "xla"
    assert result["peak_device_memory_bytes"] is None and result["launches"] == {}


def test_evaluator_is_shared(monkeypatch, tmp_path):
    """main builds one FidEvaluator and hands it to every variant."""
    seen = []
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(fid, "FidEvaluator", lambda input_size, device, group: (
        "evaluator", input_size, device, group))
    monkeypatch.setattr(measure_baseline, "run_variant",
                        lambda variant, epochs, eval_fid, evaluator, *a: seen.append(
                            (variant, epochs, eval_fid, evaluator)) or {"variant": variant})
    assert measure_baseline.main(["--epochs", "2", "--device", "cpu",
                                  "--variants", "baseline", "indexed"]) == 0
    evaluator = ("evaluator", 299, torch.device("cpu"), None)
    assert seen == [("baseline", 2, True, evaluator), ("indexed", 2, True, evaluator)]
    written = json.loads((tmp_path / "build" / "baseline_results.json").read_text())
    assert written["epochs"] == 2 and [r["variant"] for r in written["results"]] == [
        "baseline", "indexed"]
    assert written["world_size"] == 1


def test_without_a_card_the_command_exits_with_a_message():
    assert not torch.cuda.is_available()
    with pytest.raises(SystemExit, match="no CUDA device"):
        measure_baseline.main(["--epochs", "1"])
