"""Three faults of the port against the JAX reference, repaired:
  * `data_parallel="on"` asked for several devices and silently trained on
    one: `check_supported` now refuses it ("auto" and "off" are one
    device, as in JAX on one device);
  * the CLI could not choose the histogram path, and the card trained the
    histogram variant on its slowest one: `--histogram-impl` defaults to
    "pallas2" on a CUDA device and "xla" on the CPU;
  * the L1 evaluation replayed training's dropout masks (both seeded
    seed + 2): the state's generators now take seed + 4 and + 5, apart
    from the evaluations' seed + 1, + 2 and + 3, as the JAX Trainer keeps
    them apart.
"""

import pytest
import torch

from palette_and_histo_gan_tpu_torch import check_supported, cli
from palette_and_histo_gan_tpu_torch import config as tconfig
from palette_and_histo_gan_tpu_torch.data import loader
from palette_and_histo_gan_tpu_torch.eval import metrics
from palette_and_histo_gan_tpu_torch.train import state as tstate
from palette_and_histo_gan_tpu_torch.train.trainer import Trainer

NARROW = dict(down_filters=(8,) * 6, up_filters=(8,) * 6)
EVALUATION_SEED_OFFSETS = (1, 2, 3)  # the JAX Trainer's evaluations


def test_check_supported_refuses_data_parallel_on():
    config = tconfig.config_for_variant("histogram", data_parallel="on")
    for device in ("cpu", "cuda"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
            check_supported(config, device)


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
    monkeypatch.setattr(metrics, "report_l1", lambda *a: seeds.append(a[-1]) or (0.0, 0.0))
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
