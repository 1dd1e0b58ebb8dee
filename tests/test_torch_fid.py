"""The port's FID (palette_and_histo_gan_tpu_torch/eval/fid.py,
models/inception.py) against the JAX package's on the same numpy inputs,
on the CPU:

  * the resize coordinates and the nearest-neighbour resize, both quirk
    modes: exactly equal;
  * InceptionV3 activations on the JAX variables bridged to the port, with
    randomized BN beta, mean and var (identity BN would hide a
    mis-assigned unit), 8 images at batch 3 so the pad path runs: within
    1e-4 of the largest activation;
  * strict weight loading: a missing, extra or mis-shaped key raises
    naming it; PHG_INCEPTION_WEIGHTS naming no file raises, naming an .npz
    loads it;
  * the float64 statistics and distances: activation_statistics against
    numpy.cov, Newton-Schulz against scipy, the rank-deficient regime of
    the reference (44 samples, 2048 features) for the low-rank and eigh
    paths against the scipy formula and the port's low-rank against JAX's;
  * FidEvaluator.compare against JAX's (quirks off, [0, 255] images), and
    TF32 pinned off inside the evaluator with the caller's settings
    restored;
  * the PNG directory loader against JAX's (PIL) with the channels kept;
  * Trainer.fit with evaluate_fid writes fid/train and fid/test and ends
    bit-equal to the same fit without it; the CLI runs the callback.
The JAX InceptionV3 is built once, at input_size 75.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from PIL import Image
from threadpoolctl import threadpool_limits

from palette_and_histo_gan_tpu.eval import fid as jfid
from palette_and_histo_gan_tpu.models import inception as jinception
from palette_and_histo_gan_tpu_torch import cli
from palette_and_histo_gan_tpu_torch import config as tconfig
from palette_and_histo_gan_tpu_torch.data import loader
from palette_and_histo_gan_tpu_torch.eval import fid
from palette_and_histo_gan_tpu_torch.models import convert, inception
from palette_and_histo_gan_tpu_torch.models.convert import flatten_tree
from palette_and_histo_gan_tpu_torch.train import trainer as trainer_mod
from palette_and_histo_gan_tpu_torch.utils import logging as log_utils
from palette_and_histo_gan_tpu_torch.utils import visualization as viz

SIZE = 75  # keras InceptionV3's smallest input: keeps both forwards cheap
BATCH = 3
REL = 1e-4  # activations: of the largest |activation| (CPU convs sum in other orders)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread and one BLAS thread while this file runs. The suite
    runs several test processes on the host's cores at once, and a process's
    default of a thread a core makes them contend: in a full run of the
    suite this file took 1,013 s and its rank-deficient test 518 s, which
    takes about 15 s in a process of its own."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def bridged():
    """(JAX evaluator, port evaluator, flat weights): the JAX module's
    PRNGKey(0) kernels with randomized BN statistics, in both packages;
    quirks off, batch 3, input 75."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv(inception.WEIGHTS_ENV, raising=False)
        jev = jfid.FidEvaluator(batch_size=BATCH, reference_quirks=False, input_size=SIZE)
        pev = fid.FidEvaluator(batch_size=BATCH, reference_quirks=False, input_size=SIZE,
                               device="cpu")
    leaves, _ = jax.tree_util.tree_flatten_with_path(jev.variables)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in leaves}
    rng = np.random.default_rng(11)
    for key, value in flat.items():
        if key.endswith("/var"):
            flat[key] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
        elif key.endswith(("/mean", "/beta")):
            flat[key] = rng.normal(0, 0.1, value.shape).astype(np.float32)
    jev.variables = jinception.params_from_flat(jev.model, flat, input_size=SIZE)
    pev.model.load_state_dict(convert.inception_state_dict_from_flat(flat, pev.model))
    return jev, pev, flat


@pytest.fixture(scope="module")
def random_flat():
    return inception.random_flat_params(inception.InceptionV3())


def images(seed, n, c=4):
    return (np.random.default_rng(seed).random((n, 64, 64, c)) * 255).astype(np.float32)


@pytest.mark.parametrize("out_size,in_size", [(299, 64), (75, 64), (3, 4), (3, 3), (299, 299)])
def test_nn_indices_equal_jax(out_size, in_size):
    ours = fid._nn_indices(out_size, in_size).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jfid._nn_indices(out_size, in_size)))


@pytest.mark.parametrize("quirks", [True, False])
def test_scale_images_nn_equals_jax(quirks):
    x = np.random.default_rng(0).random((2, 64, 64, 4)).astype(np.float32)
    ours = fid.scale_images_nn(torch.from_numpy(x), 299, quirks).numpy()
    theirs = np.asarray(jfid.scale_images_nn(x, 299, quirks))
    assert ours.shape == (2, 299, 299, 3)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(
        fid.preprocess_input(torch.from_numpy(x)).numpy(), np.asarray(jfid.preprocess_input(x))
    )


def test_inception_activations_equal_jax_with_randomized_bn(bridged):
    jev, pev, _ = bridged
    x = images(1, 8)
    theirs = np.asarray(jev.activations(x))
    ours = pev.activations(x).numpy()
    assert ours.shape == theirs.shape == (8, 2048) and ours.dtype == np.float32
    assert theirs.std() > 1e-3  # not degenerate
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=REL * np.abs(theirs).max())


def test_units_enumerate_in_creation_order():
    model = inception.InceptionV3()
    assert len(model.units) == inception.NUM_CONVBN
    shapes = [tuple(u.weight.shape) for u in model.units]
    assert shapes[:3] == [(32, 3, 3, 3), (32, 32, 3, 3), (64, 32, 3, 3)]
    assert shapes[-1] == (192, 2048, 1, 1)  # mixed 10's pool projection
    assert [u.padding for u in model.units[31:33]] == [(0, 0), (0, 3)]  # mixed 4's 1x1, 1x7


def test_conv_flops_is_inceptions_published_count():
    macs = inception.conv_flops(inception.InceptionV3(), 299) / 2
    assert abs(macs / 5.72e9 - 1) < 0.01  # InceptionV3 at 299: 5.72 G multiply-adds


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_weight_loading_is_strict(random_flat, fault):
    flat = dict(random_flat)
    key = "params/ConvBN_17/mean"
    if fault == "missing":
        del flat[key]
    elif fault == "extra":
        key = "params/ConvBN_94/beta"
        flat[key] = np.zeros(8, np.float32)
    else:
        key = "params/ConvBN_5/Conv_0/kernel"
        flat[key] = flat[key][:, :, :, :-1]
    with pytest.raises(ValueError, match=key):
        convert.inception_state_dict_from_flat(flat, inception.InceptionV3())


def test_weights_file_is_loaded_and_a_missing_one_raises(tmp_path, monkeypatch, random_flat):
    monkeypatch.setenv(inception.WEIGHTS_ENV, str(tmp_path / "nowhere.npz"))
    with pytest.raises(FileNotFoundError, match="nowhere.npz"):
        inception.load_params(SIZE, "cpu")
    with pytest.raises(FileNotFoundError):
        fid.FidEvaluator(input_size=SIZE, device="cpu")
    flat = {k: v + np.float32(0.5) for k, v in random_flat.items()}
    np.savez(tmp_path / "weights.npz", **flat)
    monkeypatch.setenv(inception.WEIGHTS_ENV, str(tmp_path / "weights.npz"))
    model = inception.load_params(SIZE, "cpu")
    assert not model.training
    assert torch.equal(model.units[7].var, torch.from_numpy(flat["params/ConvBN_7/var"]))
    kernel = flat["params/ConvBN_93/Conv_0/kernel"].transpose(3, 2, 0, 1)
    assert torch.equal(model.units[93].weight, torch.from_numpy(np.ascontiguousarray(kernel)))


def test_weights_argument_comes_before_the_variable(tmp_path, monkeypatch, random_flat):
    """`weights` names the file in place of PHG_INCEPTION_WEIGHTS, and a
    `weights` naming no file raises even with the variable unset."""
    monkeypatch.delenv(inception.WEIGHTS_ENV, raising=False)
    with pytest.raises(FileNotFoundError, match="nowhere.npz"):
        fid.FidEvaluator(input_size=SIZE, device="cpu", weights=str(tmp_path / "nowhere.npz"))
    flat = {k: v + np.float32(0.25) for k, v in random_flat.items()}
    np.savez(tmp_path / "weights.npz", **flat)
    monkeypatch.setenv(inception.WEIGHTS_ENV, str(tmp_path / "missing.npz"))
    ev = fid.FidEvaluator(input_size=SIZE, device="cpu", weights=str(tmp_path / "weights.npz"))
    assert torch.equal(ev.model.units[7].var, torch.from_numpy(flat["params/ConvBN_7/var"]))


def test_random_weights_are_he_normal_from_seed_0(random_flat):
    again = inception.random_flat_params(inception.InceptionV3())
    assert all(np.array_equal(v, again[k]) for k, v in random_flat.items())
    kernel = random_flat["params/ConvBN_93/Conv_0/kernel"]  # 1x1, 2048 in
    assert abs(kernel.std() * np.sqrt(2048 / 2.0) - 1.0) < 0.01
    assert not random_flat["params/ConvBN_0/mean"].any()


def test_activation_statistics_match_numpy():
    acts = np.random.default_rng(4).normal(size=(10, 8)).astype(np.float32)
    mu, sigma = fid.activation_statistics(torch.from_numpy(acts))
    assert mu.dtype == sigma.dtype == torch.float64
    np.testing.assert_allclose(mu.numpy(), acts.astype(np.float64).mean(0), rtol=1e-12)
    np.testing.assert_allclose(sigma.numpy(), np.cov(acts.astype(np.float64), rowvar=False),
                               rtol=1e-12, atol=1e-14)


def test_sqrtm_newton_schulz_matches_scipy():
    from scipy.linalg import sqrtm

    a = np.random.default_rng(1).normal(size=(32, 32))
    psd = a @ a.T + 32 * np.eye(32)
    ours = fid.sqrtm_newton_schulz(torch.from_numpy(psd)).numpy()
    np.testing.assert_allclose(ours, np.real(sqrtm(psd)), rtol=1e-10, atol=1e-10)
    assert not fid.sqrtm_newton_schulz(torch.zeros(4, 4, dtype=torch.float64)).any()


def test_rank_deficient_regime_matches_scipy_and_jax():
    """44 samples of 2048 features: rank-43 covariances, where scipy's
    sqrtm warns of singularity. The float64 low-rank and eigh paths stay
    within 1e-5 of the scipy formula (scipy's sqrtm of the singular product
    is the inexact side); the port's low-rank within 1e-4 of JAX's float32
    one; identical sets give 0 by the low-rank path and nearly 0 by eigh
    (its clipped near-zero eigenvalues)."""
    rng = np.random.default_rng(17)
    a = rng.normal(size=(44, 2048)).astype(np.float32)
    b = (a + rng.normal(0, 0.5, a.shape)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    mu1, s1 = fid.activation_statistics(ta)
    mu2, s2 = fid.activation_statistics(tb)
    # one BLAS thread: scipy's sqrtm of a 2048x2048 product takes ~15 s
    # either way, and many times that when the test workers' threads contend
    with threadpool_limits(1):
        ref = fid.frechet_distance_scipy(mu1, s1, mu2, s2)
    lowrank = float(fid.frechet_distance_lowrank(ta, tb))
    eigh = float(fid.frechet_distance(mu1, s1, mu2, s2))
    assert abs(lowrank - ref) <= 1e-5 * abs(ref)
    assert abs(eigh - ref) <= 1e-5 * abs(ref)
    theirs = float(jfid.frechet_distance_lowrank(a, b))
    assert abs(lowrank - theirs) <= 1e-4 * abs(theirs)
    assert abs(float(fid.frechet_distance_lowrank(ta, ta))) <= 1e-9 * abs(ref)
    assert abs(float(fid.frechet_distance(mu1, s1, mu1, s1))) <= 1e-5 * abs(ref)


def test_compare_matches_jax(bridged):
    jev, pev, _ = bridged
    a = images(5, 8)
    b = np.clip(a + np.random.default_rng(6).normal(0, 60, a.shape), 0, 255).astype(np.float32)
    theirs = jev.compare(a, b)
    ours = pev.compare(a, b)
    assert np.isfinite(ours) and abs(ours - theirs) <= 1e-3 * abs(theirs)
    assert abs(pev.compare(a, b, method="eigh") - ours) <= 1e-4 * abs(ours)
    assert abs(pev.compare(a, a)) <= 1e-9 * abs(ours)
    with pytest.raises(ValueError, match="unknown FID method"):
        pev.compare(a, b, method="sqrtm")


@pytest.mark.parametrize("caller", [(True, "high"), (False, "highest")])
def test_evaluator_pins_tf32_off_and_restores_the_callers_settings(caller):
    ev = fid.FidEvaluator(batch_size=2, input_size=SIZE, device="cpu")
    seen = []
    ev.model.register_forward_pre_hook(lambda *_: seen.append(
        (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())))
    before = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    try:
        torch.backends.cudnn.allow_tf32 = caller[0]
        torch.set_float32_matmul_precision(caller[1])
        ev.activations(images(2, 3))
        after = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    finally:
        torch.backends.cudnn.allow_tf32 = before[0]
        torch.set_float32_matmul_precision(before[1])
    assert seen == [(False, "highest")] * 2
    assert after == caller


@pytest.mark.parametrize("channels", [3, 4])
def test_directory_loader_equals_jax(tmp_path, channels):
    x = images(7, 3, channels).astype(np.uint8)
    for i, name in enumerate(["2.png", "10.png", "0.png"]):  # read sorted as strings
        viz._write_png(x[i], str(tmp_path / name))
    ours = fid.load_directory_of_images(str(tmp_path))
    theirs = jfid.load_directory_of_images(str(tmp_path))
    assert ours.shape == theirs.shape == (3, 64, 64, channels) and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours[::-1], x)


def test_directory_loader_refuses_other_colour_types(tmp_path):
    Image.fromarray(np.zeros((64, 64), np.uint8), mode="L").save(tmp_path / "gray.png")
    with pytest.raises(ValueError, match="colour type 0"):
        fid.load_directory_of_images(str(tmp_path))


NARROW = dict(down_filters=(8,) * 6, up_filters=(8,) * 6, batch_size=4, dataset_sizes=(20,))


def test_fit_with_evaluate_fid_writes_fid_and_leaves_training_alone(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.backends.mkldnn, "enabled", False)  # one summation order
    monkeypatch.delenv(inception.WEIGHTS_ENV, raising=False)
    written = []
    monkeypatch.setattr(log_utils.MetricsWriter, "scalars",
                        lambda self, metrics, step: written.append((dict(metrics), step)))
    evaluator = fid.FidEvaluator(input_size=SIZE, device="cpu")
    runs = []
    for callbacks, ev in ((["evaluate_fid", "evaluate_l1"], evaluator), (["evaluate_l1"], None)):
        config = tconfig.config_for_variant("baseline", temp_folder=str(tmp_path / str(len(runs))),
                                            **NARROW)
        datasets = loader.datasets_from_arrays(*loader.synthetic_arrays(config, 3), "cpu")
        t = trainer_mod.Trainer(config, "cpu", datasets, fid_evaluator=ev)
        t.fit(steps=4, update_steps=2, callbacks=callbacks)
        runs.append(t)
    fids = [(m, step) for m, step in written if "fid/train" in m]
    assert [step for _, step in fids] == [0, 1, 2]
    assert all(np.isfinite(m["fid/train"]) and np.isfinite(m["fid/test"]) for m, _ in fids)
    assert runs[0].phase_seconds["evaluate_fid"] > 0
    assert runs[0].history == runs[1].history
    ours, theirs = (flatten_tree(t.state.state_dict()) for t in runs)
    for key, value in ours.items():
        assert torch.equal(value, theirs[key]) if isinstance(value, torch.Tensor) \
            else value == theirs[key], key
    # the report draws the same masks whenever it runs
    assert runs[0].report_fid() == runs[0].report_fid()


def test_cli_runs_evaluate_fid(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv(inception.WEIGHTS_ENV, raising=False)
    monkeypatch.setattr(trainer_mod, "FidEvaluator",
                        functools.partial(fid.FidEvaluator, input_size=SIZE))
    before = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    try:
        cli.main(["--model", "baseline-no-aug", "--steps", "2", "--update-steps", "2",
                  "--synthetic", "--device", "cpu", "--dataset-sizes", "20",
                  "--down-filters", *["8"] * 6, "--up-filters", *["8"] * 6,
                  "--callbacks", "evaluate_fid"])
    finally:
        torch.backends.cudnn.allow_tf32 = before[0]
        torch.set_float32_matmul_precision(before[1])
    assert capsys.readouterr().out.count("FID: ") == 2
