"""The port's Trainer lifecycle on the CPU at narrow width
(palette_and_histo_gan_tpu_torch/train/trainer.py, cli.py):

  * an interrupted run, resumed from its checkpoint in a fresh Trainer,
    equals the uninterrupted run bit for bit (parameters, both optimizers'
    moments and step counts, both generators' states, the step, the
    per-step losses) for baseline (augmentation on, so both generators
    carry weight), histogram under "pallas2" (the kernels' plain versions
    on the CPU) and indexed; a preview or patch map in between does not
    move training's generators (tests/test_trainer.py:192 is the model);
  * the preview generators' seeds are not training's; FID still raises;
  * the CLI: --resume with --init-* exits, --data-roots without matching
    --dataset-sizes exits, and a 2-chunk run with the lifecycle flags
    writes its previews, strips, weights and image dump, which --resume
    then continues.
"""

import glob
import os

import pytest
import torch

from palette_and_histo_gan_tpu_torch import cli
from palette_and_histo_gan_tpu_torch import config as tconfig
from palette_and_histo_gan_tpu_torch.data import loader
from palette_and_histo_gan_tpu_torch.models.convert import flatten_tree
from palette_and_histo_gan_tpu_torch.native import png_io
from palette_and_histo_gan_tpu_torch.train import checkpoint as ckpt
from palette_and_histo_gan_tpu_torch.train.state import TRAIN_SEED_OFFSETS
from palette_and_histo_gan_tpu_torch.train.trainer import Trainer, preview_seed

NARROW = dict(down_filters=(8,) * 6, up_filters=(8,) * 6, batch_size=4, dataset_sizes=(20,))
NARROW_FLAGS = ["--down-filters", *["8"] * 6, "--up-filters", *["8"] * 6]


def narrow_trainer(variant, temp_folder, **kw):
    config = tconfig.config_for_variant(variant, temp_folder=str(temp_folder), **NARROW, **kw)
    if config.is_indexed:
        datasets = loader.indexed_datasets_from_arrays(
            *loader.synthetic_indexed_arrays(config, 3), "cpu", config.palette_ordering,
            config.seed,
        )
    else:
        datasets = loader.datasets_from_arrays(*loader.synthetic_arrays(config, 3), "cpu")
    return Trainer(config, "cpu", datasets)


def generator_states(state):
    return state.aug_generator.get_state(), state.dropout_generator.get_state()


@pytest.mark.parametrize("variant,overrides", [
    ("baseline", {}),
    ("histogram", {"histogram_impl": "pallas2"}),
    ("indexed", {}),
])
def test_resumed_run_equals_uninterrupted(tmp_path, monkeypatch, variant, overrides):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.backends.mkldnn, "enabled", False)  # one summation order
    whole = narrow_trainer(variant, tmp_path / "a", **overrides)
    whole.fit(steps=4, update_steps=2)

    first = narrow_trainer(variant, tmp_path / "b", **overrides)
    first.fit(steps=2, update_steps=2)
    # previews and patch maps draw from generators of their own
    before = generator_states(first.state)
    first.preview_generated_images(first.select_examples_for_visualization(), step=7)
    first.show_discriminated_images("train", 2)
    assert all(torch.equal(x, y) for x, y in zip(before, generator_states(first.state)))

    resumed = narrow_trainer(variant, tmp_path / "b", **overrides)
    assert not ckpt.params_equal(resumed.state.generator, first.state.generator)
    assert resumed.restore_latest_checkpoint() == 2
    resumed.fit(steps=2, update_steps=2, starting_step=2)

    assert resumed.state.step == whole.state.step == 4
    ours = flatten_tree(resumed.state.state_dict())
    theirs = flatten_tree(whole.state.state_dict())
    assert ours.keys() == theirs.keys()
    for key, value in ours.items():
        if isinstance(value, torch.Tensor):
            assert torch.equal(value, theirs[key]), key
        else:
            assert value == theirs[key], key
    assert resumed.history == whole.history[2:]
    assert resumed.manager.steps() == [4]


def test_preview_seeds_are_not_training_seeds():
    seed = 47
    training = {seed + k for k in TRAIN_SEED_OFFSETS}
    seeds = {preview_seed(seed, step) for step in range(1000)}
    assert len(seeds) == 1000 and not seeds & training
    assert preview_seed(seed, 3) != preview_seed(seed + 1, 3)


def test_fit_refuses_fid_until_it_is_ported(tmp_path):
    trainer = narrow_trainer("baseline-no-aug", tmp_path)
    with pytest.raises(NotImplementedError, match="item 5"):
        trainer.fit(steps=1, update_steps=1, callbacks=["evaluate_fid"])
    assert trainer.state.step == 0


def test_cli_refuses_resume_with_import_and_misaligned_roots(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="mutually"):
        cli.main(["--resume", "--init-generator", "gen.npz", "--device", "cpu"])
    parser = cli.build_parser()
    for argv in (["--data-roots", "/a", "/b"],
                 ["--data-roots", "/a", "/b", "--dataset-sizes", "294"]):
        with pytest.raises(SystemExit):
            cli.config_from_args(parser.parse_args(argv))
    config = cli.config_from_args(parser.parse_args([
        "--data-roots", "/a", "/b", "--dataset-sizes", "100", "200", "--source", "back",
        "--target", "left", "--lambda-l1", "7", "--lambda-histogram", "2",
    ]))
    assert config.effective_data_roots == ("/a", "/b") and config.dataset_sizes == (100, 200)
    assert config.architecture_name == "back-to-left"
    assert (config.lambda_l1, config.lambda_histogram) == (7.0, 2.0)


def test_cli_lifecycle_flags_write_and_resume(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    common = ["--model", "histogram", "--batch-size", "2", "--device", "cpu", "--synthetic",
              "--dataset-sizes", "20", "--update-steps", "2", *NARROW_FLAGS]
    assert cli.main([*common, "--steps", "4", "--callbacks", "show_discriminator_output",
                     "--save-weights", "--generate-images"]) == 0
    temp = tmp_path / "temp-side2side"
    logs = glob.glob(str(temp / "logs" / "front-to-right" / "histogram" / "*"))
    assert len(logs) == 1
    grids = sorted(os.path.basename(p) for p in glob.glob(os.path.join(logs[0], "step_*.png")))
    assert grids == ["step_000000.png", "step_000002.png", "step_000004.png"]
    strips = glob.glob(os.path.join(logs[0], "discriminated_*_step_*_*.png"))
    assert len(strips) == 3 * 4  # 2 test + 2 train pairs at steps 0, 2 and 4
    for name in ("generator", "discriminator"):
        assert (tmp_path / "models" / "py" / name / "front-to-right" / "histogram" / "params.pt").is_file()
    dumps = sorted(glob.glob(str(temp / "generated-images" / "front-to-right" / "histogram" / "*.png")))
    assert len(dumps) == 3  # the test split of 20 pairs
    decoded = png_io.decode_png_rgba(dumps[0], 64 * 4 + 16, 3 * (64 * 4 + 8) + 8)
    assert decoded is not None and (decoded[..., 3] == 255).all()
    out = capsys.readouterr().out
    assert "discriminated target" in out and "Generated 3 images" in out

    assert cli.main([*common, "--steps", "6", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "Resumed from step 4" in out
    manager = ckpt.CheckpointManager(
        str(temp / "training-checkpoints" / "front-to-right" / "histogram"))
    assert manager.steps() == [6]
