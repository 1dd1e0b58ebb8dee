"""The port's serving export, server and experiment script on the CPU at
narrow width (palette_and_histo_gan_tpu_torch/models/export.py, serve.py,
run_experiment.py):

  * exported generator (tanh and softmax heads) and discriminator programs,
    saved and loaded back, equal the modules with dropout off, twice over;
    the models/exported/... layout; a fresh process loads and runs a
    program without the port's network code;
  * the port's program equals the JAX package's exported program
    (export_generator_serialized) on bridged weights;
  * `serve export --checkpoint` exports the newest checkpoint; `serve
    serve` pads the tail batch with its first image, quantizes by
    truncation and writes RGBA PNGs; it refuses a program whose input is
    not RGBA;
  * run_experiment trains with the three callbacks, saves the weights and
    dumps the test images.
"""

import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from palette_and_histo_gan_tpu import config as jconfig
from palette_and_histo_gan_tpu.models import export as jexport
from palette_and_histo_gan_tpu.train import state as jstate
from palette_and_histo_gan_tpu_torch import config as tconfig
from palette_and_histo_gan_tpu_torch import run_experiment, serve
from palette_and_histo_gan_tpu_torch.data import loader
from palette_and_histo_gan_tpu_torch.eval import fid
from palette_and_histo_gan_tpu_torch.models import convert
from palette_and_histo_gan_tpu_torch.models import export
from palette_and_histo_gan_tpu_torch.models.inception import WEIGHTS_ENV
from palette_and_histo_gan_tpu_torch.native import png_io
from palette_and_histo_gan_tpu_torch.train import trainer as trainer_mod
from palette_and_histo_gan_tpu_torch.train.state import build_models
from palette_and_histo_gan_tpu_torch.utils import visualization as viz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(down_filters=(8,) * 6, up_filters=(8,) * 6, dataset_sizes=(20,))


def narrow_config(variant="baseline", **kw):
    return tconfig.config_for_variant(variant, **{**NARROW, **kw})


def saved_and_loaded(program, path):
    torch.export.save(program, str(path))
    return export.load_exported(str(path))


def sources(seed, n, channels=4):
    return torch.from_numpy(
        np.random.default_rng(seed).uniform(-1, 1, (n, 64, 64, channels)).astype(np.float32))


@pytest.mark.parametrize("variant", ["baseline", "indexed"])
def test_generator_program_equals_the_module_without_dropout(tmp_path, variant):
    config = narrow_config(variant)
    g, _ = build_models(config, "cpu", 3)
    program = saved_and_loaded(export.export_generator(config, g, batch_size=3),
                               tmp_path / "g.pt2")
    x = sources(0, 3, config.generator_in_channels)
    with torch.no_grad():
        want = g(x, None, deterministic=True)
        got, again = program(x), program(x)
        dropped = g(x, torch.Generator().manual_seed(0))
    assert got.shape == (3, 64, 64, config.generator_out_channels)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert torch.equal(got, again)
    assert not torch.allclose(dropped, want)  # the module has dropout to turn off
    assert export.input_shape(program) == (3, 64, 64, config.generator_in_channels)


def test_discriminator_program_equals_the_module(tmp_path):
    config = narrow_config()
    _, d = build_models(config, "cpu", 3)
    program = saved_and_loaded(export.export_discriminator(config, d), tmp_path / "d.pt2")
    target, source = sources(1, 1), sources(2, 1)
    with torch.no_grad():
        got, want = program(target, source), d(target, source)
    assert got.shape == (1, 32, 32, 1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_save_exported_layout_and_refusals(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    config = narrow_config()
    g, _ = build_models(config, "cpu", 3)
    path = export.save_exported(config, "generator", export.export_generator(config, g))
    assert path == os.path.join("models", "exported", "generator", config.architecture_name,
                                "baseline", "program.pt2")
    assert os.path.isfile(path)
    with pytest.raises(NotImplementedError, match="infer_head_conv"):
        export.export_generator(narrow_config(infer_head_conv="nchw"), g)


def test_a_fresh_process_runs_a_program_without_the_network_code(tmp_path):
    config = narrow_config()
    g, _ = build_models(config, "cpu", 3)
    torch.export.save(export.export_generator(config, g, batch_size=2), str(tmp_path / "g.pt2"))
    x = sources(4, 2)
    np.save(tmp_path / "x.npy", x.numpy())
    with torch.no_grad():
        np.save(tmp_path / "want.npy", g(x, None, deterministic=True).numpy())
    program = textwrap.dedent("""
        import json, sys
        import numpy as np, torch
        from palette_and_histo_gan_tpu_torch.models.export import load_exported
        program = load_exported("g.pt2")
        with torch.no_grad():
            got = program(torch.from_numpy(np.load("x.npy"))).numpy()
        print(json.dumps({
            "equal": bool(np.array_equal(got, np.load("want.npy"))),
            "loaded": sorted(m for m in sys.modules if m.startswith(
                ("palette_and_histo_gan_tpu_torch.models.networks",
                 "palette_and_histo_gan_tpu_torch.train", "jax"))),
        }))
    """)
    proc = subprocess.run([sys.executable, "-c", program], cwd=str(tmp_path),
                          env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"equal": True, "loaded": []}


def test_program_equals_the_jax_exported_program(tmp_path):
    jax_config = jconfig.config_for_variant("baseline", **NARROW)
    models = jstate.build_models(jax_config)
    state = jstate.create_train_state(jax_config, models, jax.random.PRNGKey(0))
    blob = jexport.export_generator_serialized(jax_config, models, state.g_params, batch_size=2)
    theirs_fn = jax.export.deserialize(blob).call

    config = narrow_config()
    g, _ = build_models(config, "cpu", 3)
    g_tree = jax.tree_util.tree_map(np.asarray, state.g_params)
    g.load_state_dict(convert.generator_state_dict_from_flax(g_tree, g))
    program = saved_and_loaded(export.export_generator(config, g, batch_size=2),
                               tmp_path / "g.pt2")
    x = sources(5, 2)
    with torch.no_grad():
        ours = program(x).numpy()
    theirs = np.asarray(theirs_fn(x.numpy()))
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-5)


def test_padded_batches_repeat_the_chunks_first_image():
    source = np.arange(5, dtype=np.float32)[:, None]
    chunks = list(serve.padded_batches(source, 3))
    assert [n for _, n in chunks] == [3, 2]
    np.testing.assert_array_equal(chunks[0][0][:, 0], [0, 1, 2])
    np.testing.assert_array_equal(chunks[1][0][:, 0], [3, 4, 3])


def test_serve_export_restores_the_checkpoint_and_serve_writes_rgba(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(serve, "config_for_variant", functools.partial(
        tconfig.config_for_variant, **NARROW))
    with pytest.raises(SystemExit, match="no checkpoint"):
        serve.main(["export", "--model", "baseline", "--checkpoint", "--device", "cpu"])
    config = narrow_config(batch_size=4)
    t = trainer_mod.Trainer(config, "cpu", loader.datasets_from_arrays(
        *loader.synthetic_arrays(config, 3), "cpu"))
    t.fit(steps=2, update_steps=2)
    serve.main(["export", "--model", "baseline", "--batch-size", "2", "--checkpoint",
                "--out", "program.pt2", "--device", "cpu"])
    program = export.load_exported("program.pt2")

    rng = np.random.default_rng(9)
    pixels = rng.integers(0, 256, (5, 64, 64, 4), dtype=np.uint8)
    os.makedirs("in")
    for i, img in enumerate(pixels):
        viz._write_png(img, os.path.join("in", f"{i}.png"))
    serve.main(["serve", "--program", "program.pt2", "--input-dir", "in",
                "--output-dir", "out"])

    x = torch.from_numpy(pixels.astype(np.float32) / 127.5 - 1.0)
    with torch.no_grad():
        trained = t.state.generator(x[:2], None, deterministic=True)
        torch.testing.assert_close(program(x[:2]), trained, rtol=1e-5, atol=1e-6)
        fake = torch.cat([program(x[0:2]), program(x[2:4]), program(x[[4, 4]])[:1]]).numpy()
    want = ((fake + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
    assert (want != np.rint(((fake + 1.0) * 127.5).clip(0, 255))).any()  # truncation shows
    for i in range(5):
        path = os.path.join("out", f"{i}.png")
        assert png_io.png_header(path) == (64, 64, 6)
        np.testing.assert_array_equal(png_io.decode_png_rgba(path, 64, 64), want[i])


def test_serve_refuses_a_program_that_is_not_rgba(tmp_path):
    config = narrow_config("indexed")
    g, _ = build_models(config, "cpu", 3)
    torch.export.save(export.export_generator(config, g), str(tmp_path / "p.pt2"))
    with pytest.raises(SystemExit, match="not RGBA"):
        serve.main(["serve", "--program", str(tmp_path / "p.pt2"), "--input-dir",
                    str(tmp_path)])


def test_run_experiment_with_the_three_callbacks(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv(WEIGHTS_ENV, raising=False)
    monkeypatch.setattr(run_experiment, "config_for_variant", functools.partial(
        tconfig.config_for_variant, **NARROW))
    monkeypatch.setattr(trainer_mod, "FidEvaluator",
                        functools.partial(fid.FidEvaluator, input_size=75))
    before = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    try:
        assert run_experiment.main(["--model", "baseline", "--synthetic", "--device", "cpu",
                                    "--steps", "2", "--update-steps", "2",
                                    "--save-weights"]) == 0
    finally:
        torch.backends.cudnn.allow_tf32 = before[0]
        torch.set_float32_matmul_precision(before[1])
    out = capsys.readouterr().out
    assert out.count("FID: ") == 2 and out.count("L1: ") == 2
    assert out.count("discriminated target") == 8
    config = narrow_config()
    for which in ("generator", "discriminator"):
        assert os.path.isfile(os.path.join("models", "py", which, config.architecture_name,
                                           "baseline", "params.pt"))
    dumps = os.path.join(config.temp_folder, "generated-images", config.architecture_name,
                         "baseline")
    assert sorted(os.listdir(dumps)) == [f"{i}.png" for i in range(3)]
