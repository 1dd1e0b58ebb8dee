"""Faults of the port against the JAX reference, repaired:
  * `data_parallel="on"` asked for several devices and silently trained on
    one: since data parallelism is ported it trains over the process
    group's ranks (tests/test_torch_parallel.py holds it); "auto" and "off"
    without a process group are one device;
  * the CLI could not choose the histogram path, and the card trained the
    histogram variant on its slowest one: `--histogram-impl` defaults to
    "pallas2" on a CUDA device and "xla" on the CPU;
  * the L1 evaluation replayed training's dropout masks (both seeded
    seed + 2): the state's generators now take seed + 4 and + 5, apart
    from the evaluations' seed + 1, + 2 and + 3, as the JAX Trainer keeps
    them apart;
  * float32 ran in TF32 on the card wherever no entry point turned TF32
    off (PyTorch's cuDNN default is TF32): `serve export`, `serve serve`,
    `convert_weights --verify` and every Trainer built from the library
    now run their float32 work under the one config.py::float32_exact,
    which eval/fid.py shares. The flags are recorded inside each forward
    with a caller that left TF32 on; the caller's flags come back after.
"""

import functools
import gc
import os
import weakref

import numpy as np
import pytest
import torch

from palette_and_histo_gan_tpu_torch import check_supported, cli, convert_weights, serve
from palette_and_histo_gan_tpu_torch import config as tconfig
from palette_and_histo_gan_tpu_torch.data import loader
from palette_and_histo_gan_tpu_torch.eval import fid, metrics
from palette_and_histo_gan_tpu_torch.models import convert, export, networks
from palette_and_histo_gan_tpu_torch.train import state as tstate
from palette_and_histo_gan_tpu_torch.train.trainer import Trainer
from palette_and_histo_gan_tpu_torch.utils import visualization as viz

NARROW = dict(down_filters=(8,) * 6, up_filters=(8,) * 6)
EVALUATION_SEED_OFFSETS = (1, 2, 3)  # the JAX Trainer's evaluations


@pytest.mark.parametrize("data_parallel", ["auto", "off"])
def test_check_supported_takes_one_device(data_parallel):
    check_supported(tconfig.config_for_variant("histogram", data_parallel=data_parallel), "cpu")


@pytest.mark.parametrize(
    "device,impl", [("cuda", "pallas2"), ("cuda:0", "pallas2"), ("cpu", "xla")]
)
def test_cli_histogram_impl_defaults_by_device(device, impl):
    args = cli.build_parser().parse_args(["--model", "histogram", "--device", device])
    assert args.histogram_impl is None
    assert cli.histogram_impl(args) == impl


def test_cli_histogram_impl_flag_wins_and_lists_its_choices():
    parser = cli.build_parser()
    args = parser.parse_args(["--histogram-impl", "pallas", "--device", "cuda"])
    assert cli.histogram_impl(args) == "pallas"
    assert parser._option_string_actions["--histogram-impl"].choices == ("xla", "pallas", "pallas2")
    assert "--histogram-impl" in parser.format_help()
    # the config's own default stays "xla": one set of keyword arguments
    # builds the JAX config and the port's
    assert tconfig.Config().histogram_impl == "xla"


def test_state_generators_take_seeds_no_evaluation_uses():
    seed = 47
    config = tconfig.config_for_variant("histogram", **NARROW)
    state = tstate.create_train_state(config, "cpu", seed)
    seeds = {state.aug_generator.initial_seed(), state.dropout_generator.initial_seed()}
    assert seeds == {seed + 4, seed + 5}
    assert not seeds & {seed + k for k in EVALUATION_SEED_OFFSETS}


def test_first_l1_masks_differ_from_first_training_masks(monkeypatch):
    """The Trainer's L1 report draws its dropout from the seed it hands
    eval/metrics.py::report_l1; the first masks there are not the first
    masks of training."""
    config = tconfig.config_for_variant("histogram", dataset_sizes=(8,), **NARROW)
    trainer = Trainer(config, "cpu", loader.datasets_from_arrays(
        *loader.synthetic_arrays(config, 3), "cpu"))
    seeds = []
    monkeypatch.setattr(metrics, "report_l1", lambda *a, **kw: seeds.append(a[-1]) or (0.0, 0.0))
    trainer.report_l1()
    assert seeds == [config.seed + 2]

    shape = (4, 8, 2, 2)  # the first dropout layer's output at this width
    evaluation = torch.Generator()
    evaluation.manual_seed(seeds[0])
    training = trainer.state.dropout_generator
    first_training = torch.rand(shape, generator=training) < 0.5
    first_evaluation = torch.rand(shape, generator=evaluation) < 0.5
    assert not torch.equal(first_training, first_evaluation)
    # the same seed would replay them
    again = torch.Generator()
    again.manual_seed(training.initial_seed())
    assert torch.equal(torch.rand(shape, generator=again) < 0.5, first_training)


CALLER = (True, "high")  # a caller that left TF32 on
EXACT = (False, "highest")


def flags() -> tuple:
    return torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()


@pytest.fixture
def tf32_caller():
    """The caller's flags set to CALLER for the test, the session's back
    after it."""
    before = flags()
    torch.backends.cudnn.allow_tf32, _ = CALLER
    torch.set_float32_matmul_precision(CALLER[1])
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before[0]
        torch.set_float32_matmul_precision(before[1])


def recording(module: torch.nn.Module, seen: list) -> torch.nn.Module:
    """`module`, appending the flags to `seen` before each forward."""
    module.register_forward_pre_hook(lambda *_: seen.append(flags()))
    return module


def test_fid_shares_the_one_float32_exact():
    assert fid.float32_exact is tconfig.float32_exact


def test_float32_exact_pins_tf32_off_and_restores_the_callers_flags(tf32_caller):
    with tconfig.float32_exact():
        assert flags() == EXACT
        with tconfig.float32_exact():
            assert flags() == EXACT
        assert flags() == EXACT
    assert flags() == CALLER
    with pytest.raises(RuntimeError), tconfig.float32_exact():
        raise RuntimeError
    assert flags() == CALLER


def test_serve_export_and_serve_run_without_tf32(tmp_path, monkeypatch, tf32_caller):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(serve, "config_for_variant", functools.partial(
        tconfig.config_for_variant, **NARROW))
    seen = []
    real_export = export.export_generator
    monkeypatch.setattr(export, "export_generator", lambda config, g, b: real_export(
        config, recording(g, seen), b))
    serve.main(["export", "--model", "baseline", "--batch-size", "2", "--out", "p.pt2",
                "--device", "cpu"])
    assert seen and set(seen) == {EXACT} and flags() == CALLER

    seen.clear()
    real_load = export.load_exported
    monkeypatch.setattr(export, "load_exported", lambda path: recording(real_load(path), seen))
    os.makedirs("in")
    rng = np.random.default_rng(4)
    for i in range(3):
        viz._write_png(rng.integers(0, 256, (64, 64, 4), dtype=np.uint8),
                       os.path.join("in", f"{i}.png"))
    assert serve.main(["serve", "--program", "p.pt2", "--input-dir", "in",
                       "--output-dir", "out"]) == 0
    assert seen == [EXACT] * 2 and flags() == CALLER  # 3 images at batch 2
    assert sorted(os.listdir("out")) == ["0.png", "1.png", "2.png"]


def test_convert_weights_verify_runs_without_tf32(tmp_path, monkeypatch, tf32_caller):
    seen = []
    for name in ("build_generator", "build_discriminator"):
        real = getattr(networks, name)
        monkeypatch.setattr(networks, name, functools.partial(
            lambda real, *a, **kw: recording(real(*a, **kw), seen), real))
    archive = str(tmp_path / "disc_keras.npz")
    np.savez(archive, *[np.full(shape, 0.01, np.float32)
                        for _, shape, _ in convert.discriminator_weight_spec(4)])
    assert convert_weights.main(["--discriminator", archive, "--out-dir", str(tmp_path),
                                 "--verify", "--device", "cpu"]) == 0
    assert seen == [EXACT] and flags() == CALLER


TRAINER_CALLS = {
    "fit": lambda t: t.fit(steps=2, update_steps=1, callbacks=["evaluate_l1",
                                                                "show_discriminator_output"]),
    "train_chunk": lambda t: t.train_chunk(
        t.state, (t.train_ds.sources, t.train_ds.targets), 1),
    "report_l1": lambda t: t.report_l1(),
    "preview": lambda t: t.preview_generated_images(t.select_examples_for_visualization()),
    "patch_maps": lambda t: t.show_discriminated_images("test", 1),
    "image_dumps": lambda t: t.generate_images_from_dataset("test", 2),
}


@pytest.mark.parametrize("call", sorted(TRAINER_CALLS))
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_trainer_float32_work_runs_without_tf32(call, compute_dtype, tmp_path, tf32_caller):
    """A float32 Trainer's forwards see TF32 off, a bfloat16 one's the
    caller's flags; after the call the caller's flags hold either way."""
    config = tconfig.config_for_variant(
        "baseline", dataset_sizes=(8,), batch_size=2, compute_dtype=compute_dtype,
        temp_folder=str(tmp_path), **NARROW)
    trainer = Trainer(config, "cpu", loader.datasets_from_arrays(
        *loader.synthetic_arrays(config, 3), "cpu"))
    seen = []
    recording(trainer.state.generator, seen)
    TRAINER_CALLS[call](trainer)
    assert seen and set(seen) == {EXACT if compute_dtype == "float32" else CALLER}
    assert flags() == CALLER


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_a_dropped_trainer_is_freed_without_the_cyclic_gc(compute_dtype, tmp_path):
    """The float32 scope around the chunk holds no reference to the
    Trainer: dropping the last reference frees its state (on a card, its
    device memory) at once."""
    config = tconfig.config_for_variant(
        "baseline", dataset_sizes=(8,), batch_size=2, compute_dtype=compute_dtype,
        temp_folder=str(tmp_path), **NARROW)
    arrays = loader.synthetic_arrays(config, 3)
    gc.disable()
    try:
        for _ in range(2):  # the process's first Trainer may be held by one-time set-up
            trainer = Trainer(config, "cpu", loader.datasets_from_arrays(*arrays, "cpu"))
            trainer.fit(steps=1, update_steps=1)
            generator = weakref.ref(trainer.state.generator)
            del trainer
        assert generator() is None
    finally:
        gc.enable()
