"""The port's import of the reference's keras weights against the JAX
package's, and its converter.

* the weight specs equal the JAX package's for the RGBA (4 -> 4) and the
  indexed (1 -> 256) channel counts;
* `get_weights()`-ordered arrays (tests/parity_utils.py's deterministic
  weights, in spec order) through `generator_state_dict_from_keras` /
  `discriminator_state_dict_from_keras` equal, bit for bit, the port's
  bridge of the JAX package's `keras_*_weights_to_flax` tree, for both
  channel counts;
* the full-width forward from those arrays against the TF fixtures
  `networks_rgba.npz` and `networks_indexed.npz` at tests/test_parity.py's
  tolerances (fake 1e-4, D real 1e-4, D fake 5e-4; probabilities 1e-5,
  argmax maps on > 99.9% of pixels);
* the refusals of tests/test_convert.py: a wrong count, a wrong shape
  naming the weight, an archive with named keys;
* `python -m palette_and_histo_gan_tpu_torch.convert_weights` on the CPU
  writes the arrays the JAX package's `save_params_npz` writes of the same
  tree, verifies on the CPU when asked and refuses `--verify` on a CUDA
  device it cannot see; the CLI's `--init-generator` /
  `--init-discriminator` take its files.
"""

import os

import numpy as np
import pytest
import torch

from palette_and_histo_gan_tpu.models import convert as jconvert
from palette_and_histo_gan_tpu_torch import cli, convert_weights
from palette_and_histo_gan_tpu_torch.config import config_for_variant
from palette_and_histo_gan_tpu_torch.models import convert, networks
from tests import parity_utils as pu

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CHANNELS = {"rgba": (4, 4), "indexed": (1, 256)}
VARIANT = {"rgba": "histogram", "indexed": "indexed"}


def keras_arrays(spec) -> list:
    """The parity weights in `get_weights()` order."""
    return [pu.make_param(name, shape, kind) for name, shape, kind in spec]


def nets(kind):
    config = config_for_variant(VARIANT[kind])
    return (networks.build_generator(config, torch.float32),
            networks.build_discriminator(config, torch.float32))


@pytest.mark.parametrize("kind", sorted(CHANNELS))
def test_specs_equal_the_jax_specs(kind):
    c_in, c_out = CHANNELS[kind]
    assert convert.generator_weight_spec(c_in, c_out) == jconvert.generator_weight_spec(c_in, c_out)
    assert convert.discriminator_weight_spec(c_in) == jconvert.discriminator_weight_spec(c_in)
    assert (convert.DOWN_FILTERS, convert.UP_FILTERS) == (jconvert.DOWN_FILTERS, jconvert.UP_FILTERS)


@pytest.mark.parametrize("kind", sorted(CHANNELS))
def test_keras_state_dicts_equal_the_jax_path_bit_for_bit(kind):
    c_in, c_out = CHANNELS[kind]
    gen, disc = nets(kind)
    g_arrays = keras_arrays(jconvert.generator_weight_spec(c_in, c_out))
    d_arrays = keras_arrays(jconvert.discriminator_weight_spec(c_in))
    for ours, want in (
        (convert.generator_state_dict_from_keras(g_arrays, gen),
         convert.generator_state_dict_from_flax(
             jconvert.keras_generator_weights_to_flax(g_arrays, c_in, c_out), gen)),
        (convert.discriminator_state_dict_from_keras(d_arrays, disc),
         convert.discriminator_state_dict_from_flax(
             jconvert.keras_discriminator_weights_to_flax(d_arrays, c_in), disc)),
    ):
        assert ours.keys() == want.keys()
        for k in ours:
            assert ours[k].dtype == torch.float32 and torch.equal(ours[k], want[k]), k


@pytest.fixture(scope="module", params=sorted(CHANNELS))
def golden_forward(request):
    kind = request.param
    c_in, c_out = CHANNELS[kind]
    gen, disc = nets(kind)
    gen.load_state_dict(convert.generator_state_dict_from_keras(
        keras_arrays(convert.generator_weight_spec(c_in, c_out)), gen))
    disc.load_state_dict(convert.discriminator_state_dict_from_keras(
        keras_arrays(convert.discriminator_weight_spec(c_in)), disc))
    g = np.load(os.path.join(GOLDEN, f"networks_{kind}.npz"))
    src, real = torch.from_numpy(g["source"]), torch.from_numpy(g["real"])
    with torch.no_grad():
        fake = gen(src, deterministic=True)
        d_real = disc(real.float(), src)
        # the indexed D sees the fixture's argmax map (tests/test_parity.py's
        # choice: a tie flipped by float32 noise is an O(100) input change)
        d_fake = disc(torch.from_numpy(g["fake_idx"]).float() if kind == "indexed" else fake, src)
    return kind, g, fake.numpy(), d_real.numpy(), d_fake.numpy()


def test_keras_weights_forward_matches_tf(golden_forward):
    kind, g, fake, d_real, d_fake = golden_forward
    if kind == "rgba":
        np.testing.assert_allclose(fake, g["fake"], atol=1e-4)
    else:
        np.testing.assert_allclose(fake[:, ::8, ::8, :], g["probs_slice"], atol=1e-5)
        assert (fake.argmax(-1)[..., None] == g["fake_idx"]).mean() > 0.999
    np.testing.assert_allclose(d_real, g["d_real"], atol=1e-4)
    np.testing.assert_allclose(d_fake, g["d_fake"], atol=5e-4)


def test_wrong_count_raises():
    gen, disc = nets("rgba")
    arrays = keras_arrays(convert.generator_weight_spec(4, 4))[:-1]
    with pytest.raises(ValueError, match="expected .* weight arrays"):
        convert.generator_state_dict_from_keras(arrays, gen)
    with pytest.raises(ValueError, match="expected 3 weight arrays"):
        convert.discriminator_state_dict_from_keras(arrays[:2], disc)


def test_wrong_shape_names_the_weight():
    gen, _ = nets("rgba")
    arrays = keras_arrays(convert.generator_weight_spec(4, 4))
    arrays[0] = arrays[0][:, :, :3, :]  # wrong cin
    with pytest.raises(ValueError, match="gen/down0/conv"):
        convert.generator_state_dict_from_keras(arrays, gen)
    arrays = keras_arrays(convert.generator_weight_spec(4, 4))
    gen_indexed, _ = nets("indexed")  # a 4 -> 4 model's arrays for the 1 -> 256 module
    with pytest.raises(ValueError, match="gen/down0/conv"):
        convert.generator_state_dict_from_keras(arrays, gen_indexed)


def test_keras_npz_order_and_named_keys(tmp_path):
    arrays = keras_arrays(convert.discriminator_weight_spec(4)) + [np.arange(11.0)] * 9
    path = str(tmp_path / "disc.npz")
    np.savez(path, *arrays)  # arr_0 .. arr_11: a lexical sort would misorder them
    loaded = convert.load_keras_npz(path)
    assert len(loaded) == len(arrays)
    for a, b in zip(arrays, loaded):
        np.testing.assert_array_equal(a, b)
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, kernel=np.zeros((2, 2)))
    with pytest.raises(ValueError, match="arr_0"):
        convert.load_keras_npz(bad)


@pytest.fixture(scope="module")
def keras_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("keras")
    g_arrays = keras_arrays(convert.generator_weight_spec(4, 4))
    d_arrays = keras_arrays(convert.discriminator_weight_spec(4))
    np.savez(d / "generator.npz", *g_arrays)
    np.savez(d / "discriminator.npz", *d_arrays)
    return d, g_arrays, d_arrays


def test_converter_writes_the_jax_files(keras_files, tmp_path, capsys):
    d, g_arrays, d_arrays = keras_files
    out = tmp_path / "converted"
    assert convert_weights.main([
        "--generator", str(d / "generator.npz"), "--discriminator", str(d / "discriminator.npz"),
        "--variant", "histogram", "--out-dir", str(out), "--verify", "--device", "cpu",
    ]) == 0
    printed = capsys.readouterr().out
    assert "generator: 36 arrays, 29,307,844 params" in printed
    assert printed.count("verify:") == 2 and "finite=True" in printed
    for name, tree in (
        ("generator", jconvert.keras_generator_weights_to_flax(g_arrays, 4, 4)),
        ("discriminator", jconvert.keras_discriminator_weights_to_flax(d_arrays, 4)),
    ):
        jconvert.save_params_npz(str(tmp_path / f"{name}_jax.npz"), tree)
        with np.load(out / f"{name}_flax.npz") as ours, \
                np.load(tmp_path / f"{name}_jax.npz") as want:
            assert sorted(ours.files) == sorted(want.files)
            for k in want.files:
                assert ours[k].dtype == want[k].dtype
                np.testing.assert_array_equal(ours[k], want[k], err_msg=k)


def test_converter_refuses_an_absent_card_and_a_wrong_variant(keras_files, tmp_path):
    d, _, _ = keras_files
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert_weights.main(["--generator", str(d / "generator.npz"),
                              "--out-dir", str(tmp_path), "--verify"])
    assert not os.path.exists(tmp_path / "generator_flax.npz")
    with pytest.raises(ValueError, match="gen/down0/conv"):
        convert_weights.main(["--generator", str(d / "generator.npz"), "--variant", "indexed",
                              "--out-dir", str(tmp_path)])
    with pytest.raises(SystemExit):
        convert_weights.main(["--out-dir", str(tmp_path)])


def test_cli_init_takes_the_converted_files(keras_files, tmp_path, monkeypatch, capsys):
    d, _, _ = keras_files
    out = tmp_path / "converted"
    convert_weights.main(["--generator", str(d / "generator.npz"),
                          "--discriminator", str(d / "discriminator.npz"),
                          "--variant", "baseline-no-aug", "--out-dir", str(out)])
    monkeypatch.chdir(tmp_path)
    assert cli.main([
        "--model", "baseline-no-aug", "--steps", "1", "--update-steps", "1",
        "--batch-size", "2", "--device", "cpu", "--synthetic", "--dataset-sizes", "8",
        "--init-generator", str(out / "generator_flax.npz"),
        "--init-discriminator", str(out / "discriminator_flax.npz"),
    ]) == 0
    assert "on cpu: 1 steps" in capsys.readouterr().out
