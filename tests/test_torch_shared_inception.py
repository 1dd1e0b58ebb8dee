"""The shared-init InceptionV3 drawn by the port without TensorFlow
(models/inception.py::shared_init_flat_params and the command
`python -m palette_and_histo_gan_tpu_torch.convert_inception --shared-init`)
against scripts/make_shared_inception.py, on the CPU:

  * (a) the pinned draw order is a permutation of the 94 units, and each
    draw has its unit's HWIO shape;
  * (b) the dict's sha256 (keys in sorted order, each with its array's
    bytes) equals the pinned digest: the bit-for-bit claim without
    TensorFlow;
  * (c) in one TensorFlow subprocess, the script's own `main()` (its
    ART / H5 / NPZ pointed at the test's directory) writes the `.npz`,
    and a second keras InceptionV3 lists its Conv2Ds' creation indices in
    `model.layers` order: that list is the pinned order, and the port's
    dict equals the written file key for key, bit for bit;
  * (d) the dict as a file, loaded through PHG_INCEPTION_WEIGHTS by the
    JAX package's `load_params` and by the port's, gives the same
    activations at input 75 within tests/test_torch_fid.py's 1e-4 of the
    largest activation, and they spread across images;
  * (e) the command writes the file (its digest the pinned one), refuses
    an existing path, `--h5` together with `--shared-init`, `--out` with
    `--shared-init`, and a path in the repository's artifacts/.
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
from threadpoolctl import threadpool_limits

from palette_and_histo_gan_tpu.eval import fid as jfid
from palette_and_histo_gan_tpu_torch import convert_inception
from palette_and_histo_gan_tpu_torch.eval import fid
from palette_and_histo_gan_tpu_torch.models import inception

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "make_shared_inception.py")
# flat_digest of what scripts/make_shared_inception.py writes (TensorFlow
# 2.21, Keras 3)
PINNED_SHA256 = "8d822a60e11f24a721c58e6649fc42c84236f7a832fcb88b8910b39f63fe54b3"
SIZE = 75
REL = 1e-4  # tests/test_torch_fid.py's: of the largest |activation|


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


@pytest.fixture(scope="module")
def module():
    return inception.InceptionV3()


@pytest.fixture(scope="module")
def shared(module):
    return inception.shared_init_flat_params(module)


def test_draw_order_is_a_permutation_and_each_draw_has_its_units_shape(module, shared):
    order = inception.SHARED_INIT_DRAW_ORDER
    assert sorted(order) == list(range(inception.NUM_CONVBN))
    assert order != tuple(range(inception.NUM_CONVBN))  # the trap: not the unit order
    assert len(shared) == 4 * inception.NUM_CONVBN
    for k, u in enumerate(module.units):
        out_c, in_c, kh, kw = u.weight.shape
        kernel = shared[f"params/ConvBN_{k}/Conv_0/kernel"]
        assert kernel.shape == (kh, kw, in_c, out_c) and kernel.dtype == np.float32
        for name, value in (("beta", 0.0), ("mean", 0.0), ("var", 1.0)):
            array = shared[f"params/ConvBN_{k}/{name}"]
            assert array.dtype == np.float32 and array.shape == (out_c,)
            assert (array == value).all()
        # He-normal: the kernel's spread is sqrt(2 / fan_in)
        np.testing.assert_allclose(kernel.std(), np.sqrt(2.0 / (kh * kw * in_c)), rtol=0.1)


def test_digest_equals_the_pinned_one(shared):
    assert inception.flat_digest(shared) == inception.SHARED_INIT_SHA256 == PINNED_SHA256
    moved = dict(shared)
    key = "params/ConvBN_93/Conv_0/kernel"
    moved[key] = shared[key].copy()
    moved[key].flat[0] = np.nextafter(moved[key].flat[0], np.float32(1))
    assert inception.flat_digest(moved) != PINNED_SHA256


TF_PROGRAM = textwrap.dedent(
    """
    import importlib.util, json, os, re, sys
    os.environ["TF_CPP_MIN_LOG_LEVEL"] = "3"
    os.environ["CUDA_VISIBLE_DEVICES"] = "-1"
    import tensorflow as tf

    script, out = sys.argv[1], sys.argv[2]
    spec = importlib.util.spec_from_file_location("make_shared_inception", script)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.ART = out
    mod.H5 = os.path.join(out, "inception_shared.weights.h5")
    mod.NPZ = os.path.join(out, "inception_shared.npz")
    code = mod.main()

    # the draw order again: each Conv2D of model.layers by its creation rank
    model = tf.keras.applications.InceptionV3(
        include_top=False, pooling="avg", input_shape=(299, 299, 3), weights=None)
    convs = [l for l in model.layers if l.__class__.__name__ == "Conv2D"]
    index = [int(m.group(1)) if (m := re.search(r"_(\\d+)$", l.name)) else 0 for l in convs]
    rank = {i: r for r, i in enumerate(sorted(index))}
    print(json.dumps({"exit": code, "order": [rank[i] for i in index]}))
    """
)


def test_port_equals_what_the_tensorflow_script_writes(shared, tmp_path):
    if importlib.util.find_spec("tensorflow") is None:
        pytest.skip("needs TensorFlow")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", TF_PROGRAM, SCRIPT, str(tmp_path)],
                          cwd=str(tmp_path), env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["exit"] == 0
    assert tuple(out["order"]) == inception.SHARED_INIT_DRAW_ORDER
    with np.load(tmp_path / "inception_shared.npz") as f:
        written = {k: f[k] for k in f.files}
    assert list(written) == list(shared)
    for key, array in shared.items():
        assert written[key].dtype == array.dtype and written[key].shape == array.shape, key
        assert np.array_equal(written[key], array), key
    assert inception.flat_digest(written) == PINNED_SHA256


def test_shared_weights_give_jax_activations(shared, tmp_path, monkeypatch):
    path = tmp_path / "inception_shared.npz"
    np.savez(path, **shared)
    monkeypatch.setenv(inception.WEIGHTS_ENV, str(path))
    jev = jfid.FidEvaluator(batch_size=3, reference_quirks=False, input_size=SIZE)
    pev = fid.FidEvaluator(batch_size=3, reference_quirks=False, input_size=SIZE, device="cpu")
    x = (np.random.default_rng(5).random((6, 64, 64, 4)) * 255).astype(np.float32)
    theirs = np.asarray(jev.activations(x))
    ours = pev.activations(x).numpy()
    assert ours.shape == theirs.shape == (6, 2048)
    scale = np.abs(theirs).max()
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=REL * scale)
    # He-normal kernels keep the features apart (the script's reason for them)
    assert theirs.std(axis=0).mean() > 1e-2 * np.abs(theirs).mean()


def test_command_writes_the_file_and_refuses_what_it_must(tmp_path, capsys):
    out = tmp_path / "inception_shared.npz"
    assert convert_inception.main(["--shared-init", str(out)]) == 0
    printed = capsys.readouterr().out
    assert f"sha256 {PINNED_SHA256}" in printed
    assert f"export {inception.WEIGHTS_ENV}={out}" in printed
    with np.load(out) as f:
        assert inception.flat_digest({k: f[k] for k in f.files}) == PINNED_SHA256
    written = out.read_bytes()

    refusals = (
        (["--shared-init", str(out)], "exists"),
        (["--shared-init", str(tmp_path / "b.npz"), "--h5", SCRIPT], "not allowed with"),
        (["--shared-init", str(tmp_path / "c.npz"), "--out", str(tmp_path / "d.npz")],
         "--out belongs to --h5"),
        (["--shared-init", os.path.join(REPO, "artifacts", "inception_shared.npz")],
         "artifacts"),
    )
    for argv, message in refusals:
        with pytest.raises(SystemExit) as e:
            convert_inception.main(argv)
        assert e.value.code == 2
        assert message in capsys.readouterr().err, argv
    assert out.read_bytes() == written
    assert sorted(os.listdir(tmp_path)) == ["inception_shared.npz"]
