"""The port's checkpoints, weight files and weight import
(palette_and_histo_gan_tpu_torch/train/checkpoint.py, `TrainState.
state_dict`, `Trainer.import_network_params`), on the CPU at narrow width:

  * AsyncSaver: a snapshot's write lands at the next save or at the flush,
    an in-place update after `save()` does not reach the snapshot, only
    the newest checkpoint is kept, and a failed write raises out of `fit`;
  * restore with no checkpoint leaves the state as it is; a missing, extra
    or mis-shaped key raises before anything changes;
  * weight files round-trip; a missing one raises with its path;
  * the JAX package's `save_params_npz` of a JAX `create_train_state`'s
    networks, imported by the port, equals the bridged Flax weights, with
    the moments and the step reset; a missing, extra or mis-shaped key
    raises ValueError naming it.
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch

from palette_and_histo_gan_tpu import config as jconfig
from palette_and_histo_gan_tpu.models import convert as jconvert
from palette_and_histo_gan_tpu.train import state as jstate
from palette_and_histo_gan_tpu_torch import config as tconfig
from palette_and_histo_gan_tpu_torch.data import loader
from palette_and_histo_gan_tpu_torch.models import convert
from palette_and_histo_gan_tpu_torch.train import checkpoint as ckpt
from palette_and_histo_gan_tpu_torch.train import state as tstate
from palette_and_histo_gan_tpu_torch.train.steps import make_train_step
from palette_and_histo_gan_tpu_torch.train.trainer import Trainer

NARROW = dict(down_filters=(8,) * 6, up_filters=(8,) * 6, batch_size=4, dataset_sizes=(12,))


def narrow_config(tmp_path, variant="baseline", **kw):
    return tconfig.config_for_variant(variant, temp_folder=str(tmp_path / "temp"), **NARROW, **kw)


def train_one_step(config, state, seed=0):
    rng = np.random.default_rng(seed)
    src, tgt = (torch.from_numpy(rng.integers(0, 256, (4, 64, 64, 4), dtype=np.uint8))
                for _ in range(2))
    make_train_step(config)(state, src, tgt)


def assert_same_state(a: dict, b: dict):
    flat_a, flat_b = convert.flatten_tree(a), convert.flatten_tree(b)
    assert flat_a.keys() == flat_b.keys()
    for key, value in flat_a.items():
        if isinstance(value, torch.Tensor):
            assert value.dtype == flat_b[key].dtype and torch.equal(value, flat_b[key]), key
        else:
            assert value == flat_b[key], key


def test_async_saver_writes_lag_one_save_and_snapshots_are_copies(tmp_path):
    config = narrow_config(tmp_path)
    state = tstate.create_train_state(config, "cpu", config.seed)
    manager = ckpt.make_manager(config)
    saver = ckpt.AsyncSaver(manager)
    saver.save(state)  # snapshot of step 0 pending, nothing written
    saver.wait()
    assert manager.latest_step() is None
    train_one_step(config, state)
    saver.save(state)  # writes step 0; snapshot of step 1 pending
    saver.wait()
    assert manager.steps() == [0]
    at_step_1 = copy.deepcopy(state.state_dict())
    # the next chunk updates the live state in place: not the snapshot
    with torch.no_grad():
        for p in state.generator.parameters():
            p.add_(1.0)
    train_one_step(config, state, seed=1)
    saver.flush()
    assert manager.steps() == [1]  # the newest kept: step 0 removed after step 1 landed
    assert os.listdir(manager.directory) == ["step_000000001.pt"]

    fresh = tstate.create_train_state(config, "cpu", seed=99)
    assert manager.restore(fresh) is fresh
    assert_same_state(fresh.state_dict(), at_step_1)


def test_restore_without_checkpoint_leaves_the_state(tmp_path):
    config = narrow_config(tmp_path)
    state = tstate.create_train_state(config, "cpu", config.seed)
    before = copy.deepcopy(state.state_dict())
    manager = ckpt.make_manager(config)
    assert manager.latest_step() is None
    assert manager.restore(state) is state
    assert_same_state(state.state_dict(), before)


def _missing(sd):
    del sd["generator"]["head.bias"]
    return "generator/head.bias"


def _extra(sd):
    sd["discriminator_optimizer"]["m"]["extra.weight"] = torch.zeros(3)
    return "discriminator_optimizer/m/extra.weight"


def _misshaped(sd):
    sd["generator_optimizer"]["v"]["down.0.weight"] = torch.zeros(2, 2)
    return "generator_optimizer/v/down.0.weight"


@pytest.mark.parametrize("break_it", [_missing, _extra, _misshaped])
def test_load_state_dict_is_strict(tmp_path, break_it):
    config = narrow_config(tmp_path)
    donor = tstate.create_train_state(config, "cpu", seed=5)
    train_one_step(config, donor)
    sd = copy.deepcopy(donor.state_dict())
    key = break_it(sd)
    state = tstate.create_train_state(config, "cpu", config.seed)
    before = copy.deepcopy(state.state_dict())
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        state.load_state_dict(sd)
    assert_same_state(state.state_dict(), before)


def test_failed_checkpoint_write_raises_out_of_fit(tmp_path, monkeypatch):
    config = narrow_config(tmp_path, "baseline-no-aug")
    trainer = Trainer(config, "cpu", loader.datasets_from_arrays(
        *loader.synthetic_arrays(config, 3), "cpu"))

    def refuse(step, host_state):
        raise OSError("disk full")

    monkeypatch.setattr(trainer.manager, "save", refuse)
    with pytest.raises(OSError, match="disk full"):
        trainer.fit(steps=2, update_steps=2)
    assert trainer.state.step == 2


def test_weight_files_round_trip(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    config = narrow_config(tmp_path)
    state = tstate.create_train_state(config, "cpu", config.seed)
    other = tstate.create_train_state(config, "cpu", seed=5)
    with pytest.raises(FileNotFoundError, match="generator"):
        ckpt.load_params(config, "generator", other.generator)
    for which in ("generator", "discriminator"):
        path = ckpt.save_params(config, which, getattr(state, which))
        assert path == os.path.join("models", "py", which, "front-to-right", "baseline", "params.pt")
        assert not ckpt.params_equal(getattr(other, which), getattr(state, which))
        ckpt.load_params(config, which, getattr(other, which))
        assert ckpt.params_equal(getattr(other, which), getattr(state, which))


@pytest.fixture(scope="module")
def jax_networks():
    """A JAX create_train_state's generator and discriminator trees (numpy)
    at narrow width."""
    jax_config = jconfig.config_for_variant("baseline", **NARROW)
    models = jstate.build_models(jax_config)
    state = jstate.create_train_state(jax_config, models, jax.random.PRNGKey(0))
    return (jax.tree_util.tree_map(np.asarray, state.g_params),
            jax.tree_util.tree_map(np.asarray, state.d_params))


def narrow_trainer(tmp_path):
    config = narrow_config(tmp_path)
    return Trainer(config, "cpu", loader.datasets_from_arrays(
        *loader.synthetic_arrays(config, 3), "cpu"))


def test_import_network_params_equals_bridged_jax_weights(tmp_path, jax_networks):
    g_tree, d_tree = jax_networks
    g_npz, d_npz = str(tmp_path / "g.npz"), str(tmp_path / "d.npz")
    jconvert.save_params_npz(g_npz, g_tree)
    jconvert.save_params_npz(d_npz, d_tree)
    # the port's npz functions read and write the JAX package's format
    ours = str(tmp_path / "ours.npz")
    convert.save_params_npz(ours, g_tree)
    theirs = jconvert.load_params_npz(ours)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, theirs, g_tree))
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, convert.load_params_npz(g_npz), g_tree))

    trainer = narrow_trainer(tmp_path)
    state = trainer.state
    for optimizer in (state.g_optimizer, state.d_optimizer):
        for st in optimizer.state.values():
            st["m"].fill_(1.0)
            st["v"].fill_(2.0)
            st["step"] = 3
    state.step = 7  # an import is not a resume
    trainer.import_network_params(g_npz, d_npz)
    assert ckpt.params_equal(
        state.generator, convert.generator_state_dict_from_flax(g_tree, state.generator))
    assert ckpt.params_equal(
        state.discriminator,
        convert.discriminator_state_dict_from_flax(d_tree, state.discriminator))
    assert state.step == 0
    for optimizer in (state.g_optimizer, state.d_optimizer):
        for st in optimizer.state.values():
            assert st["step"] == 0 and not st["m"].any() and not st["v"].any()


def _drop(tree):
    del tree["UpBlock_2"]["InstanceNorm_0"]["scale"]
    return "UpBlock_2/InstanceNorm_0/scale"


def _add(tree):
    tree["UpBlock_9"] = {"Conv_0": {"kernel": np.zeros((4, 4, 8, 8), np.float32)}}
    return "UpBlock_9/Conv_0/kernel"


def _reshape(tree):
    tree["DownBlock_0"]["Conv_0"]["kernel"] = np.zeros((4, 4, 4, 16), np.float32)
    return "DownBlock_0/Conv_0/kernel"


@pytest.mark.parametrize("break_it", [_drop, _add, _reshape])
def test_import_network_params_is_strict(tmp_path, jax_networks, break_it):
    g_tree = copy.deepcopy(jax_networks[0])
    name = break_it(g_tree)
    g_npz = str(tmp_path / "g.npz")
    jconvert.save_params_npz(g_npz, g_tree)
    trainer = narrow_trainer(tmp_path)
    before = copy.deepcopy(trainer.state.state_dict())
    trainer.state.step = 5
    with pytest.raises(ValueError, match=name):
        trainer.import_network_params(generator_npz=g_npz)
    trainer.state.step = 0
    assert_same_state(trainer.state.state_dict(), before)
