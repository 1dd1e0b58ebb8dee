"""The port's copy of the comparison regime
(`palette_and_histo_gan_tpu_torch/ref_regime.py`) against
`scripts/ref_regime.py`, bit for bit on the CPU: the batch order, the
reference-faithful init of the four weight specs the regime uses, the
splits and the indexed splits decoded from one synthetic dataset root
(the JAX side reads it through PHG_DATA_ROOT), and the helpers on seeded
inputs. Also the command: the seeded root it writes, its summary on the
CPU, and its exit without a card.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from palette_and_histo_gan_tpu_torch import ref_regime as regime
from palette_and_histo_gan_tpu_torch.data import loader
from palette_and_histo_gan_tpu_torch.models import convert
from tests import parity_utils as pu

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
if SCRIPTS not in sys.path:
    sys.path.insert(0, SCRIPTS)

import ref_regime as jregime  # noqa: E402


def assert_same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return regime.write_synthetic_root(str(tmp_path_factory.mktemp("regime") / "dataset"))


def test_constants_are_the_scripts():
    assert (regime.SEED, regime.BATCH, regime.FID_STEPS) == (
        jregime.SEED, jregime.BATCH, jregime.FID_STEPS)


@pytest.mark.parametrize("steps", [200, 10080])
def test_batch_order_equals_the_scripts(steps):
    got = regime.batch_order(250, steps)
    assert_same(got, jregime.batch_order(250, steps))
    assert got.shape == (steps, 4)


@pytest.mark.parametrize("spec", [
    ("generator", (4, 4)), ("generator", (1, 256)),
    ("discriminator", (4,)), ("discriminator", (1,)),
], ids=["generator-rgba", "generator-indexed", "discriminator-rgba", "discriminator-indexed"])
def test_reference_init_equals_the_scripts(spec):
    which, channels = spec
    ours = getattr(convert, f"{which}_weight_spec")(*channels)
    theirs = getattr(pu, f"{which}_param_spec")(*channels)
    assert ours == theirs
    got, want = regime.reference_init(ours), jregime.reference_init(theirs)
    assert list(got) == list(want)
    for name in want:
        assert_same(got[name], want[name])


def test_load_splits_equals_the_scripts(root, monkeypatch):
    monkeypatch.setenv("PHG_DATA_ROOT", root)
    got = regime.load_splits(root)
    assert [a.shape[0] for a in got] == [250, 250, 44, 44]
    for ours, theirs in zip(got, jregime.load_splits()):
        assert_same(ours, theirs)
    # the argument's default is the same root
    for ours, theirs in zip(regime.load_splits(), got):
        assert_same(ours, theirs)


def test_load_indexed_splits_equals_the_scripts(root, monkeypatch):
    monkeypatch.setenv("PHG_DATA_ROOT", root)
    got = regime.load_indexed_splits(root, "cpu")
    want = jregime.load_indexed_splits()
    for ours, theirs in zip(got, want):
        for a, b in zip(ours, theirs):
            assert_same(a, b)
    # the synthetic set holds labels past 255 (the hotpink filler)
    assert (got[0][1] > 255).any()


def test_decode_indexed_equals_the_scripts():
    rng = np.random.default_rng(0)
    maps = rng.integers(-3, 300, (5, 64, 64, 1)).astype(np.int32)
    palettes = rng.integers(0, 256, (5, 256, 4)).astype(np.int32)
    assert_same(regime.decode_indexed(maps, palettes), jregime.decode_indexed(maps, palettes))


@pytest.mark.parametrize("channels", [3, 4])
def test_fid_preprocess_equals_the_scripts(channels):
    images = np.random.default_rng(channels).uniform(-1, 1, (2, 64, 64, channels))
    images = images.astype(np.float32)
    got = regime.fid_preprocess(images)
    assert got.shape == (2, 299, 299, 3)
    assert_same(got, jregime.fid_preprocess(images))


def test_reference_fid_equals_the_scripts():
    rng = np.random.default_rng(1)
    a, b = (rng.standard_normal((24, 16)).astype(np.float32) + s for s in (0.0, 0.3))
    got = regime.reference_fid_from_acts(a, b)
    assert got == jregime.reference_fid_from_acts(a, b) and got > 0


def test_window_means_and_fid_steps_equal_the_scripts():
    values = np.random.default_rng(2).standard_normal(1003)
    for n in (5, 7):
        assert regime.window_means(values, n) == jregime.window_means(values, n)
    for spec in ("", "2520,5040,10080", "10080, 2520 ,", "7"):
        assert regime.parse_fid_at(spec) == jregime.parse_fid_at(spec)


def test_synthetic_root_is_the_seeded_few_colour_set(root):
    config = regime.config_for_variant("indexed")
    arrays = loader.synthetic_indexed_arrays(config, regime.SEED)
    for ours, want in zip(regime.load_splits(root), arrays):
        assert_same(ours, want)
    with pytest.raises(FileExistsError):
        regime.write_synthetic_root(root)


def test_command_summarizes_the_root_on_the_cpu(root, capsys):
    assert regime.main(["--data-root", root, "--device", "cpu"]) == 0
    first, line = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(line)
    assert first == "cpu: no card"
    assert summary["train_pairs"] == 250 and summary["test_pairs"] == 44
    assert summary["batch_order_steps"] == 10080 and summary["indexed_labels_past_255"] > 0
    assert summary["batch_order_first"] == jregime.batch_order(250, 1)[0].tolist()


def test_without_a_card_the_command_exits_with_a_message():
    assert not torch.cuda.is_available()
    with pytest.raises(SystemExit, match="no CUDA device"):
        regime.main([])
