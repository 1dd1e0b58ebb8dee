"""The PyTorch port's optimizer, train step and loader against the JAX package's.

* one keras-convention Adam trajectory against `scale_by_keras_adam`
  (rtol 1e-6: the same float32 formula), and the gap to torch.optim.Adam's
  eps placement that makes the custom optimizer necessary;
* three narrow histogram-variant steps with deterministic dropout and
  augment_probability 0, from the same bridged initialization on the same
  uint8 batches, under the default histogram ("xla"/"tri") and under each
  kernel-backed configuration ("pallas", "pallas2", histogram_bwd
  "pallas"; the JAX kernels in interpret mode, the port's plain
  versions): per-step losses (rtol 1e-4; float32 on both sides, the conv
  and histogram sums run in another order) and the parameter deltas
  after three steps (the difference within 1e-3 of each tensor's delta in
  Frobenius norm; measured 4.7e-4 at worst. Elementwise the worst entry is
  ~1% off: Adam's m / (sqrt(v) + eps) turns the summation-order error of a
  gradient near eps into a large relative error of its update);
* the loader on a synthetic dataset root (the tests/test_data.py pattern),
  the port's own PNG decoder against PIL, and the epoch-permutation
  sampler.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from palette_and_histo_gan_tpu import config as jconfig
from palette_and_histo_gan_tpu.data import loader as jloader
from palette_and_histo_gan_tpu.train import state as jstate
from palette_and_histo_gan_tpu.train import steps as jsteps
from palette_and_histo_gan_tpu_torch import cli as tcli
from palette_and_histo_gan_tpu_torch import config as tconfig
from palette_and_histo_gan_tpu_torch.data import loader as tloader
from palette_and_histo_gan_tpu_torch.models import convert
from palette_and_histo_gan_tpu_torch.train import state as tstate
from palette_and_histo_gan_tpu_torch.train import steps as tsteps
from tests.test_data import _write_synthetic_root

NARROW = dict(down_filters=(8,) * 6, up_filters=(8,) * 6)


def configs(variant, **kw):
    """The JAX package's and the port's configurations, built from the same
    keyword arguments."""
    return jconfig.config_for_variant(variant, **kw), tconfig.config_for_variant(variant, **kw)


def test_keras_adam_matches_jax():
    jax_config, config = configs("histogram")
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((64,)).astype(np.float32)
    grads = [rng.standard_normal((64,)).astype(np.float32) * s for s in (1.0, 0.3)]
    for g in grads:
        g[:8] *= 1e-7  # near-zero gradients, where the eps placement matters

    tx = jstate.make_optimizer(jax_config)
    params, opt = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    ours = tstate.KerasAdam([p], lr=config.learning_rate,
                            betas=(config.beta1, config.beta2), eps=config.adam_eps)
    q = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    theirs = torch.optim.Adam([q], lr=config.learning_rate,
                              betas=(config.beta1, config.beta2), eps=config.adam_eps)
    for g in grads:
        upd, opt = tx.update(jnp.asarray(g), opt, params)
        params = optax.apply_updates(params, upd)
        for param, optimizer in ((p, ours), (q, theirs)):
            param.grad = torch.from_numpy(g.copy())
            optimizer.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params), rtol=1e-6, atol=0)
    # torch.optim.Adam moves the near-zero-gradient entries much further
    d_keras = np.abs(np.asarray(params) - p0)[:8]
    d_torch = np.abs(q.detach().numpy() - p0)[:8]
    assert np.all(d_torch > 1.5 * d_keras)


def same_init_states(jax_config, config):
    """The JAX state from PRNGKey(0) and the port's state holding the same
    weights, bridged."""
    models = jstate.build_models(jax_config)
    jax_state = jstate.create_train_state(jax_config, models, jax.random.PRNGKey(0))
    state = tstate.create_train_state(config, "cpu", seed=0)
    convert.load_flax_params(
        state.generator, state.discriminator,
        jax.tree_util.tree_map(np.asarray, jax_state.g_params),
        jax.tree_util.tree_map(np.asarray, jax_state.d_params),
    )
    return models, jax_state, state


@pytest.mark.parametrize(
    "histogram_impl,histogram_bwd",
    [("xla", "tri"), ("pallas", "tri"), ("pallas2", "tri"), ("xla", "pallas")],
)
def test_three_histogram_steps_match_jax(histogram_impl, histogram_bwd):
    """The default histogram and the three kernel-backed configurations;
    the JAX step runs its Pallas kernels in interpret mode, the port's CPU
    tensors the kernels' plain versions."""
    jax_config, config = configs(
        "histogram", deterministic_dropout=True, augment_probability=0.0,
        donate_state=False, histogram_impl=histogram_impl,
        histogram_bwd=histogram_bwd, **NARROW,
    )
    models, jax_state, state = same_init_states(jax_config, config)
    g0 = {k: v.clone() for k, v in state.generator.state_dict().items()}
    d0 = {k: v.clone() for k, v in state.discriminator.state_dict().items()}
    jax_g0 = jax.tree_util.tree_map(np.asarray, jax_state.g_params)
    jax_d0 = jax.tree_util.tree_map(np.asarray, jax_state.d_params)

    jax_step = jsteps.make_train_step(jax_config, models)
    torch_step = tsteps.make_train_step(config)
    rng = np.random.default_rng(1)
    for _ in range(3):
        src = rng.integers(0, 256, (2, 64, 64, 4), dtype=np.uint8)
        tgt = rng.integers(0, 256, (2, 64, 64, 4), dtype=np.uint8)
        with pltpu.force_tpu_interpret_mode():
            jax_state, jm = jax_step(jax_state, jnp.asarray(src), jnp.asarray(tgt))
        tm = torch_step(state, torch.from_numpy(src), torch.from_numpy(tgt))
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    assert state.step == 3 == int(jax_state.step)

    for net, init, jax_init, jax_final, to_sd in (
        (state.generator, g0, jax_g0, jax_state.g_params,
         convert.generator_state_dict_from_flax),
        (state.discriminator, d0, jax_d0, jax_state.d_params,
         convert.discriminator_state_dict_from_flax),
    ):
        ref0 = to_sd(jax_init, net)
        ref1 = to_sd(jax.tree_util.tree_map(np.asarray, jax_final), net)
        for k, w in net.state_dict().items():
            delta = (w - init[k]).numpy()
            ref = (ref1[k] - ref0[k]).numpy()
            # zero for down.5: InstanceNorm over the 1x1 bottleneck cuts its
            # gradient on both sides, so the port must not move it either
            scale = np.linalg.norm(ref)
            assert np.linalg.norm(delta - ref) <= 1e-3 * scale, k


def test_loader_matches_jax_on_synthetic_root(tmp_path):
    root = str(tmp_path / "ds")
    _write_synthetic_root(root, 10, seed=4)
    jax_config, config = configs("baseline", data_root=root, dataset_sizes=(10,))
    ours = tloader.make_rgba_datasets(config, "cpu")
    ref = jloader.make_rgba_datasets(jax_config)
    for o, r in zip(ours, ref):
        assert o.n == r.n
        assert o.sources.dtype == torch.uint8
        np.testing.assert_array_equal(o.sources.numpy(), np.asarray(r.sources))
        np.testing.assert_array_equal(o.targets.numpy(), np.asarray(r.targets))
    assert (ours[0].n, ours[1].n) == (9, 1)


def test_native_decoder_builds_and_matches_pil(tmp_path):
    """The port's own PNG decoder, compiled at first use, decodes a split
    as PIL does."""
    from PIL import Image

    from palette_and_histo_gan_tpu_torch.native import png_io

    root = str(tmp_path / "ds")
    _write_synthetic_root(root, 4, seed=2)
    folder = os.path.join(root, "train", "2-front")
    batch = png_io.decode_folder(folder, 4)
    assert batch is not None, "the native decoder did not build"
    for i in range(4):
        with Image.open(os.path.join(folder, f"{i}.png")) as im:
            np.testing.assert_array_equal(batch[i], np.asarray(im.convert("RGBA")))
        np.testing.assert_array_equal(png_io.decode_png_rgba(os.path.join(folder, f"{i}.png")),
                                      batch[i])
    assert png_io.decode_folder(folder, 5) is None  # 4.png is missing


def test_missing_dataset_root_raises(tmp_path):
    config = tconfig.config_for_variant("baseline", data_root=str(tmp_path / "none"))
    with pytest.raises(FileNotFoundError, match="not in this repository"):
        tloader.make_rgba_datasets(config, "cpu")


def test_batch_indices_epoch_permutation():
    n, b = 10, 4  # 3 steps an epoch; the last batch wraps around
    epoch0 = [tloader.batch_indices(7, s, n, b, "cpu") for s in range(3)]
    flat = torch.cat(epoch0).tolist()
    assert sorted(set(flat)) == list(range(n))
    assert flat[10:] == flat[:2]
    again = tloader.batch_indices(7, 1, n, b, "cpu")
    assert torch.equal(again, epoch0[1])
    epoch1 = torch.cat([tloader.batch_indices(7, s, n, b, "cpu") for s in range(3, 6)])
    assert not torch.equal(epoch1, torch.cat(epoch0))


def test_cli_trains_synthetic_sprites_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)  # the metrics writer logs under ./temp-side2side
    narrow = ["8"] * 6
    rc = tcli.main([
        "--model", "histogram", "--steps", "2", "--update-steps", "1",
        "--batch-size", "2", "--device", "cpu", "--synthetic",
        "--down-filters", *narrow, "--up-filters", *narrow,
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Starting training for histogram" in out and "on cpu: 2 steps" in out
    assert (tmp_path / "temp-side2side" / "logs").is_dir()


def test_pack_rows_round_trip():
    x = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (3, 64, 64, 4), dtype=np.uint8))
    packed = tsteps.pack_rows(x)
    assert packed.dtype == torch.int32 and packed.shape == (3, 4096)
    # little-endian: byte 0 of each word is R
    assert int(packed[0, 0]) & 0xFF == int(x[0, 0, 0, 0])
    assert torch.equal(tsteps.unpack_rows(packed[[2, 0]]), x[[2, 0]])
