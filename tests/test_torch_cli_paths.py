"""The CLI's paths that no other test drives, on the CPU:

  * the dataset-root path: a dataset root written as PNGs in the dataset's
    layout (<root>/<train|test>/<i-direction>/<n>.png) with the port's own
    PNG writer, no PIL; `cli.main(["--data-root", ROOT, ...])` without
    `--synthetic` for baseline and indexed at narrow width, 2 steps; the
    Trainer's splits equal the ones built from the arrays in memory
    (indexed: the index maps and palettes too); its forwards run without
    TF32 and the caller's flags, TF32 on, hold after `main` (the CLI sets
    no process-wide mode);
  * the PNG decoder's failure: when the native library cannot be built and
    PIL is absent, the loader raises with the compiler's error, not with
    PIL's ImportError;
  * the CLI under torchrun: `torchrun --standalone --nproc-per-node=2 -m
    palette_and_histo_gan_tpu_torch.cli --device cpu --synthetic
    --data-parallel on` at narrow width, 2 steps, over Gloo; it exits 0,
    rank 1 prints nothing (torchrun's per-rank logs) and opens no file
    for writing under the working directory (an audit hook, installed in
    each rank by a sitecustomize module, records them).
"""

import glob
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from palette_and_histo_gan_tpu_torch import cli
from palette_and_histo_gan_tpu_torch import config as tconfig
from palette_and_histo_gan_tpu_torch.data import loader
from palette_and_histo_gan_tpu_torch.native import png_io
from palette_and_histo_gan_tpu_torch.utils import visualization as viz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW_FLAGS = ["--down-filters", *["8"] * 6, "--up-filters", *["8"] * 6]
DATASET_SIZE = 8  # 7 train / 1 test pairs


CALLER = (True, "high")  # a caller that left TF32 on


def flags() -> tuple:
    return torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()


@pytest.fixture
def tf32_caller():
    """The caller's flags set to CALLER for the test, the session's back
    after it."""
    before = flags()
    torch.backends.cudnn.allow_tf32 = CALLER[0]
    torch.set_float32_matmul_precision(CALLER[1])
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before[0]
        torch.set_float32_matmul_precision(before[1])


def write_dataset_root(root: str, config, arrays) -> None:
    """(train_sources, train_targets, test_sources, test_targets) as PNGs
    of config's source and target directions under `root`."""
    directions = (config.source_direction, config.target_direction)
    for split, pair in (("train", arrays[:2]), ("test", arrays[2:])):
        for direction, images in zip(directions, pair):
            folder = os.path.join(root, split, tconfig.DIRECTION_FOLDERS[direction])
            os.makedirs(folder)
            for i, img in enumerate(images):
                viz._write_png(img, os.path.join(folder, f"{i}.png"))


@pytest.mark.parametrize("variant", ["baseline", "indexed"])
def test_cli_trains_from_a_dataset_root(variant, tmp_path, monkeypatch, tf32_caller):
    monkeypatch.chdir(tmp_path)
    config = tconfig.config_for_variant(variant, dataset_sizes=(DATASET_SIZE,))
    make = loader.synthetic_indexed_arrays if config.is_indexed else loader.synthetic_arrays
    arrays = make(config, 5)
    root = str(tmp_path / "dataset")
    write_dataset_root(root, config, arrays)

    trainers, seen = [], []
    real_train = cli.train

    def train(args, config, trainer):
        trainers.append(trainer)
        trainer.state.generator.register_forward_pre_hook(lambda *_: seen.append(flags()))
        return real_train(args, config, trainer)

    monkeypatch.setattr(cli, "train", train)
    assert cli.main(["--model", variant, "--device", "cpu", "--data-root", root,
                     "--dataset-sizes", str(DATASET_SIZE), *NARROW_FLAGS,
                     "--steps", "2", "--update-steps", "1"]) == 0
    assert seen and set(seen) == {(False, "highest")} and flags() == CALLER
    (trainer,) = trainers
    assert trainer.state.step == 2 and len(trainer.history) == 2
    if config.is_indexed:
        want = loader.indexed_datasets_from_arrays(*arrays, "cpu", config.palette_ordering,
                                                   config.seed)
    else:
        want = loader.datasets_from_arrays(*arrays, "cpu")
    for ours, theirs in zip((trainer.train_ds, trainer.test_ds), want):
        assert ours.n == theirs.n
        for a, b in zip(ours, theirs):
            assert torch.equal(a, b)


def test_decoder_without_library_and_pil_raises_the_compilers_error(tmp_path, monkeypatch):
    path = str(tmp_path / "0.png")
    viz._write_png(np.zeros((64, 64, 4), np.uint8), path)
    monkeypatch.setattr(png_io, "_lib", None)
    monkeypatch.setattr(png_io, "_tried", False)
    monkeypatch.setattr(png_io, "_error", None)
    monkeypatch.setattr(png_io, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(png_io, "CXX_FLAGS", png_io.CXX_FLAGS + ("-fno-such-flag",))
    monkeypatch.setitem(sys.modules, "PIL", None)  # import PIL raises ImportError
    with pytest.raises(RuntimeError, match="g\\+\\+ exited 1:\n.*-fno-such-flag") as e:
        loader._decode_png(path)
    assert isinstance(e.value.__cause__, ImportError)


SITECUSTOMIZE = textwrap.dedent(
    """
    import atexit, json, os, sys

    _rank = os.environ.get("RANK")
    _root = os.path.realpath(os.getcwd())
    _writes = []
    _WRITE = os.O_WRONLY | os.O_RDWR | os.O_CREAT | os.O_APPEND | os.O_TRUNC

    def _audit(event, args):
        if event == "open":
            path, flags = args[0], args[2]
            if not isinstance(path, (str, bytes)) or not flags & _WRITE:
                return
        elif event in ("os.mkdir", "os.rename", "os.remove"):
            path = args[0]
        else:
            return
        path = os.path.realpath(os.fsdecode(path))
        if path.startswith(_root + os.sep):
            _writes.append([event, path])

    def _report():
        with open(os.path.join(os.environ["PHG_AUDIT_DIR"], f"rank{_rank}.json"), "w") as f:
            json.dump(_writes, f)

    if _rank is not None:
        sys.addaudithook(_audit)
        atexit.register(_report)
    """
)


def test_cli_under_torchrun_over_gloo_only_rank_0_prints_and_writes(tmp_path):
    run, audit, logs, site = (tmp_path / d for d in ("run", "audit", "logs", "site"))
    for d in (run, audit, site):
        d.mkdir()
    (site / "sitecustomize.py").write_text(SITECUSTOMIZE)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(site), REPO]),
               PHG_AUDIT_DIR=str(audit), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        ["torchrun", "--standalone", "--nproc-per-node=2", "--log-dir", str(logs),
         "--redirects", "1", "-m", "palette_and_histo_gan_tpu_torch.cli", "--device", "cpu",
         "--synthetic", "--data-parallel", "on", "--model", "histogram", "--batch-size", "4",
         "--dataset-sizes", str(DATASET_SIZE), *NARROW_FLAGS, "--steps", "2",
         "--update-steps", "1"],
        cwd=str(run), env=env, capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    stdout = {
        int(os.path.basename(os.path.dirname(p))): open(p).read()
        for p in glob.glob(str(logs / "**" / "stdout.log"), recursive=True)
    }
    assert sorted(stdout) == [0, 1]
    assert "Starting training for histogram" in stdout[0]
    assert "data parallel, gloo x 2 ranks, batch 2 a rank" in stdout[0]
    assert stdout[1] == ""
    writes = {r: json.loads((audit / f"rank{r}.json").read_text()) for r in (0, 1)}
    assert writes[1] == []
    # the hook sees rank 0's writes: its events, previews and checkpoint
    written = [p for _, p in writes[0]]
    assert any(os.path.basename(p).startswith("events.out.tfevents") for p in written)
    assert any(p.endswith("step_000002.png") for p in written)
    assert any("training-checkpoints" in p for p in written)
    assert glob.glob(str(run / "temp-side2side" / "training-checkpoints" / "**" / "*.pt"),
                     recursive=True)
