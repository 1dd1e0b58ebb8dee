"""The port's keras InceptionV3 converters (models/inception.py::
convert_keras_model, ::convert_keras_weights and the command
`python -m palette_and_histo_gan_tpu_torch.convert_inception`) on the CPU:

  * against the JAX package's `convert_keras_model`, bit for bit, on a
    duck-typed stand-in of a keras model: layers whose class names are
    Conv2D / BatchNormalization, in shuffled order, named with the suffixes
    of a fresh keras session and of one whose name counters started at 94,
    with seeded weights of the port's unit shapes; the dict also loads
    strictly into the port's InceptionV3;
  * 93 pairs and a conv/BN channel mismatch raise, in both packages;
  * end to end, in one TensorFlow subprocess: a randomized keras
    InceptionV3 (weights=None, input 75, nothing downloaded) saved as
    `.weights.h5`, the command run as `python -m` runs it (runpy, so that
    TensorFlow is imported once), and the port's InceptionV3 loaded from
    the `.npz` through PHG_INCEPTION_WEIGHTS within 1e-3 of keras'
    `predict` (tests/test_fid.py's full-network check of the JAX module);
  * the command refuses an `--h5` that names no file.
"""

import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from palette_and_histo_gan_tpu.models import inception as jinception
from palette_and_histo_gan_tpu_torch import convert_inception
from palette_and_histo_gan_tpu_torch.models import convert, inception

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Conv2D:
    def __init__(self, name, kernel):
        self.name, self._w = name, [kernel]

    def get_weights(self):
        return self._w


class BatchNormalization:
    def __init__(self, name, beta, mean, var):
        self.name, self._w = name, [beta, mean, var]

    def get_weights(self):
        return self._w


class Activation:
    name = "activation"

    def get_weights(self):
        return []


class StandIn:
    def __init__(self, layers):
        self.layers = layers


def _suffix(base: str, k: int) -> str:
    return base if k == 0 else f"{base}_{k}"


def stand_in(first: int, seed: int = 0, units=None) -> StandIn:
    """A keras-like notop InceptionV3: the port's unit shapes, the k-th
    created pair named with suffix first + k, layers shuffled."""
    rng = np.random.default_rng(seed)
    units = list(inception.InceptionV3().units) if units is None else units
    layers = [Activation()]
    for k, u in enumerate(units):
        out_c, in_c, kh, kw = u.weight.shape
        kernel = rng.standard_normal((kh, kw, in_c, out_c), dtype=np.float32)
        beta, mean = (rng.standard_normal(out_c, dtype=np.float32) for _ in range(2))
        var = rng.uniform(0.5, 1.5, out_c).astype(np.float32)
        layers.append(Conv2D(_suffix("conv2d", first + k), kernel))
        layers.append(BatchNormalization(_suffix("batch_normalization", first + k),
                                         beta, mean, var))
    order = rng.permutation(len(layers))
    return StandIn([layers[i] for i in order])


@pytest.fixture(scope="module")
def units():
    return list(inception.InceptionV3().units)


@pytest.mark.parametrize("first", [0, 94])
def test_convert_keras_model_equals_jax_bit_for_bit(first, units):
    model = stand_in(first, units=units)
    ours = inception.convert_keras_model(model)
    theirs = jinception.convert_keras_model(model)
    assert list(ours) == list(theirs)
    assert len(ours) == 4 * inception.NUM_CONVBN
    for key in ours:
        assert ours[key].dtype == theirs[key].dtype
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
    # every unit's kernel has the port's unit k's shape: loads strictly
    module = inception.InceptionV3()
    module.load_state_dict(convert.inception_state_dict_from_flat(ours, module))


def test_convert_keras_model_refuses_what_jax_refuses(units):
    short = stand_in(0, units=units)
    short.layers = [l for l in short.layers if l.name not in ("conv2d_93",
                                                              "batch_normalization_93")]
    for package in (inception, jinception):
        with pytest.raises(ValueError, match="expected 94 Conv2D/BatchNormalization pairs, got 93/93"):
            package.convert_keras_model(short)

    swapped = stand_in(0, units=units)
    bn = {l.name: l for l in swapped.layers if isinstance(l, BatchNormalization)}
    # unit 0 has 32 channels, unit 2 has 64
    bn["batch_normalization"]._w, bn["batch_normalization_2"]._w = (
        bn["batch_normalization_2"]._w, bn["batch_normalization"]._w)
    for package in (inception, jinception):
        with pytest.raises(ValueError, match="conv/bn channel mismatch at unit 0"):
            package.convert_keras_model(swapped)


def test_command_refuses_an_h5_that_names_no_file(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        convert_inception.main(["--h5", "imagenet", "--out", str(tmp_path / "w.npz")])
    assert e.value.code == 2
    assert "names no file" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "w.npz")


KERAS_PROGRAM = textwrap.dedent(
    """
    import json, os, runpy, sys
    os.environ["TF_CPP_MIN_LOG_LEVEL"] = "3"
    os.environ["CUDA_VISIBLE_DEVICES"] = "-1"
    import numpy as np
    import tensorflow as tf

    out = sys.argv[1]
    model = tf.keras.applications.InceptionV3(
        include_top=False, pooling="avg", weights=None, input_shape=(75, 75, 3))
    # randomized, so BN's statistics and offsets are exercised
    rng = np.random.default_rng(11)
    for layer in model.layers:
        new = []
        for w, v in zip(layer.get_weights(), layer.weights):
            if w.ndim == 4:
                fan_in = w.shape[0] * w.shape[1] * w.shape[2]
                new.append(rng.normal(0, np.sqrt(2.0 / fan_in), w.shape).astype(np.float32))
            elif "variance" in v.name:
                new.append(rng.uniform(0.5, 1.5, w.shape).astype(np.float32))
            else:
                new.append(rng.normal(0, 0.1, w.shape).astype(np.float32))
        if new:
            layer.set_weights(new)
    h5 = os.path.join(out, "inception.weights.h5")
    model.save_weights(h5)
    x = rng.uniform(-1, 1, (4, 75, 75, 3)).astype(np.float32)
    np.savez(os.path.join(out, "keras.npz"), x=x, features=model.predict(x, verbose=0))
    sys.argv = ["convert_inception", "--h5", h5, "--out", os.path.join(out, "inception.npz")]
    try:
        runpy.run_module("palette_and_histo_gan_tpu_torch.convert_inception", run_name="__main__")
    except SystemExit as e:
        print(json.dumps({"exit": e.code}))
    """
)


def test_converted_keras_inception_matches_keras_features(tmp_path, monkeypatch):
    if importlib.util.find_spec("tensorflow") is None:
        pytest.skip("needs TensorFlow")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", KERAS_PROGRAM, str(tmp_path)],
                          cwd=str(tmp_path), env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {"exit": 0}
    npz = tmp_path / "inception.npz"
    assert f"export PHG_INCEPTION_WEIGHTS={npz}" in lines

    monkeypatch.setenv(inception.WEIGHTS_ENV, str(npz))
    model = inception.load_params(75, "cpu")
    with np.load(tmp_path / "keras.npz") as f:
        x, theirs = f["x"], f["features"]
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
    assert ours.shape == theirs.shape == (4, 2048)
    assert theirs.std() > 1e-6
    scale = np.abs(theirs).max()
    np.testing.assert_allclose(ours, theirs, rtol=1e-3, atol=1e-3 * scale)
