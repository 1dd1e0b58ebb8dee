"""The port's throughput sweep (`palette_and_histo_gan_tpu_torch/sweep.py`)
against `scripts/sweep.py`, at narrow widths on the CPU.

* its record has every key of the script's record;
* `flops_per_image` is the JAX `utils/flops.py::train_step_flops_per_image`
  for each variant;
* over a world of two, img/s a card and MFU are halved (a pure function);
* the sweep times the production program: the parameters after its warm-up
  and timed steps equal those after as many `make_train_chunk` steps from
  the same seed on the same data, bit for bit (the same ops in one
  process);
* `--device cpu` gives `clock: "host"` and null device fields, and writes
  only under `build/`;
* only `torch.cuda.OutOfMemoryError` becomes an error row; a ValueError
  raises.
"""

import ast
import functools
import json
import os

import pytest
import torch
from threadpoolctl import threadpool_limits

from palette_and_histo_gan_tpu.config import config_for_variant as jax_config_for_variant
from palette_and_histo_gan_tpu.utils import flops as jflops
from palette_and_histo_gan_tpu_torch import sweep
from palette_and_histo_gan_tpu_torch.train.state import create_train_state
from palette_and_histo_gan_tpu_torch.train.steps import make_train_chunk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(down_filters=(8,) * 6, up_filters=(8,) * 6)
VARIANTS = ("baseline-no-aug", "baseline", "histogram", "indexed")


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


def script_record_keys() -> set:
    """The keys scripts/sweep.py::measure_variant writes into its record:
    the dict literal bound to `record` and every `record[...] =`."""
    with open(os.path.join(REPO, "scripts", "sweep.py")) as f:
        tree = ast.parse(f.read())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name) and target.id == "record" and isinstance(
                        node.value, ast.Dict):
                    keys.update(k.value for k in node.value.keys)
                if isinstance(target, ast.Subscript) and getattr(target.value, "id", "") == "record":
                    keys.add(target.slice.value)
    return keys


@pytest.fixture(scope="module")
def rows():
    """One narrow b4 float32 row of each variant, 2 timed steps."""
    return {v: sweep.measure_variant(v, 4, 2, "float32", "cpu", **NARROW) for v in VARIANTS}


def test_record_has_every_key_of_the_script(rows):
    keys = script_record_keys()
    assert {"variant", "batch", "step_seconds", "images_per_sec_per_chip", "mfu",
            "clock"} <= keys
    for row in rows.values():
        assert keys <= set(row), keys - set(row)


@pytest.mark.parametrize("variant", VARIANTS)
def test_flops_per_image_is_the_jax_count(rows, variant):
    jax_config = jax_config_for_variant(variant, batch_size=4, **NARROW)
    assert rows[variant]["flops_per_image"] == round(
        jflops.train_step_flops_per_image(jax_config))
    assert rows[variant]["variant"] == variant and rows[variant]["n_devices"] == 1


def test_world_of_two_halves_the_card_rate_and_mfu():
    one = sweep.throughput(1024, 0.05, 1, 3.1e9, "bfloat16", True)
    two = sweep.throughput(1024, 0.05, 2, 3.1e9, "bfloat16", True)
    assert two["images_per_sec"] == one["images_per_sec"] == 1024 / 0.05
    assert two["images_per_sec_per_chip"] == pytest.approx(one["images_per_sec_per_chip"] / 2)
    assert two["mfu"] == pytest.approx(one["mfu"] / 2)
    assert one["mfu"] == pytest.approx(3.1e9 * 1024 / 0.05 / 989e12)
    assert sweep.throughput(4, 0.02, 1, 1e9, "float32", True)["mfu"] == pytest.approx(
        1e9 * 200 / 67e12)
    assert sweep.throughput(4, 0.02, 1, 1e9, "float32", False)["mfu"] is None


@pytest.mark.parametrize("variant", ["histogram", "indexed"])
def test_sweep_times_the_production_chunk(variant):
    setup = sweep.prepare(variant, 4, "float32", "cpu", **NARROW)
    sweep.record(setup, 2)  # 2 warm-up + 2 timed steps
    assert setup.state.step == 4
    state = create_train_state(setup.config, "cpu", sweep.STATE_SEED)
    chunk = make_train_chunk(setup.config, sweep.MIN_DATA, setup.config.seed)
    chunk(state, sweep.synthetic_data(setup.config, sweep.MIN_DATA, "cpu"), 4)
    for ours, ref in ((setup.state.generator, state.generator),
                      (setup.state.discriminator, state.discriminator)):
        for (name, a), (_, b) in zip(ours.named_parameters(), ref.named_parameters()):
            assert torch.equal(a, b), name


def test_cpu_run_is_on_the_host_clock(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sweep, "config_for_variant",
                        functools.partial(sweep.config_for_variant, **NARROW))
    assert sweep.main(["--device", "cpu", "--variants", "baseline-no-aug", "--batches", "4",
                       "--steps", "1", "--dtype", "float32"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "cpu: no card"
    row = json.loads(lines[1])
    assert row["clock"] == "host" and row["step_seconds"] == row["host_step_seconds"] > 0
    assert row["device_step_seconds"] is None and row["peak_device_memory_bytes"] is None
    assert row["mfu"] is None and row["launches_per_step"] == {}
    with open(tmp_path / "build" / "sweep_results.json") as f:
        assert json.load(f)["results"] == [row]
    assert sorted(os.listdir(tmp_path)) == ["build"]
    with pytest.raises(ValueError, match="only under"):
        sweep.main(["--device", "cpu", "--variants", "baseline-no-aug", "--batches", "4",
                    "--steps", "1", "--out", "sweep_results.json"])


def test_only_out_of_memory_becomes_an_error_row(monkeypatch):
    def oom(setup, steps):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")

    monkeypatch.setattr(sweep, "record", oom)
    row = sweep.measure_variant("baseline-no-aug", 4, 1, "float32", "cpu",
                                {"histogram_bwd": "tri"}, **NARROW)
    assert row["variant"] == "baseline-no-aug" and row["batch"] == 4
    assert row["error"].startswith("CUDA out of memory")
    assert row["overrides"] == {"histogram_bwd": "tri"}

    def bad(setup, steps):
        raise ValueError("not a memory error")

    monkeypatch.setattr(sweep, "record", bad)
    with pytest.raises(ValueError, match="not a memory error"):
        sweep.measure_variant("baseline-no-aug", 4, 1, "float32", "cpu", **NARROW)


def test_batch_that_does_not_split_over_the_ranks_raises(monkeypatch):
    """Under data parallelism the batch is the global batch: 5 rows do not
    split over 2 ranks (train/trainer.py::data_group)."""
    import palette_and_histo_gan_tpu_torch.train.trainer as trainer

    class Two:
        world_size = 2

    monkeypatch.setattr(trainer, "make_group", lambda device: Two())
    with pytest.raises(ValueError, match="does not split"):
        sweep.prepare("baseline-no-aug", 5, "float32", "cpu", data_parallel="on", **NARROW)
