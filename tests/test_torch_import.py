"""The PyTorch port runs without JAX and without the JAX package.

* In a fresh interpreter: import the port (with its FID, export,
  serving, experiment, weight-conversion, Inception-conversion, FLOP-count
  and profiling modules), train one step of a narrow histogram-variant Trainer and one
  of a narrow indexed Trainer on the CPU (the plain augmentation and the
  plain palette index, since the tensors lie on the CPU), convert a keras
  discriminator archive with its CPU forward, and check that neither
  `jax` nor any module of `palette_and_histo_gan_tpu` was loaded, nor
  TensorFlow (only the Inception conversion imports it, when it runs),
  and that no CUDA kernel was launched.
* An AST scan of the port's sources and of chip_smoke.py finds no import
  of the JAX package or of JAX.
"""

import ast
import glob
import json
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("palette_and_histo_gan_tpu", "jax")

PROGRAM = textwrap.dedent(
    """
    import json, math, sys

    import palette_and_histo_gan_tpu_torch as port
    from palette_and_histo_gan_tpu_torch import (
        convert_inception, convert_weights, run_experiment, serve)
    from palette_and_histo_gan_tpu_torch.data import loader
    from palette_and_histo_gan_tpu_torch.eval import fid
    from palette_and_histo_gan_tpu_torch.models import export, inception
    from palette_and_histo_gan_tpu_torch.ops import augment_kernel, palette_kernel
    from palette_and_histo_gan_tpu_torch.train.trainer import Trainer
    from palette_and_histo_gan_tpu_torch.utils import flops, profiling

    narrow = dict(down_filters=(8,) * 6, up_filters=(8,) * 6, batch_size=2,
                  dataset_sizes=(8,), temp_folder=sys.argv[1])
    histories = {}
    for variant in ("histogram", "indexed"):
        config = port.config_for_variant(variant, **narrow)
        if config.is_indexed:
            arrays = loader.synthetic_indexed_arrays(config, 0)
            datasets = loader.indexed_datasets_from_arrays(*arrays, "cpu")
        else:
            datasets = loader.datasets_from_arrays(*loader.synthetic_arrays(config, 0), "cpu")
        trainer = Trainer(config, "cpu", datasets)
        trainer.fit(steps=1, update_steps=1, callbacks=["evaluate_l1"])
        histories[variant] = (trainer.state.step, trainer.history[0])
    # the converter end to end: a keras get_weights() archive of the PatchGAN
    import numpy as np
    from palette_and_histo_gan_tpu_torch.models import convert
    keras = sys.argv[1] + "/disc_keras.npz"
    np.savez(keras, *[np.full(shape, 0.01, np.float32)
                      for _, shape, _ in convert.discriminator_weight_spec(4)])
    assert convert_weights.main(["--discriminator", keras, "--out-dir", sys.argv[1],
                                 "--verify", "--device", "cpu"]) == 0
    loaded = sorted(
        m for m in sys.modules
        if m in ("jax", "palette_and_histo_gan_tpu", "tensorflow")
        or m.startswith(("jax.", "palette_and_histo_gan_tpu.", "tensorflow."))
    )
    print(json.dumps({
        "loaded": loaded,
        "launches": {**augment_kernel.launches, **palette_kernel.launches},
        "steps": {k: v[0] for k, v in histories.items()},
        "finite": all(math.isfinite(x) for _, h in histories.values() for x in h.values()),
        "metrics": {k: sorted(v[1]) for k, v in histories.items()},
    }))
    """
)


def test_port_trains_on_cpu_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", PROGRAM, str(tmp_path / "run")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert out["launches"] == {"packed": 0, "rgba": 0, "K5": 0}
    assert out["steps"] == {"histogram": 1, "indexed": 1} and out["finite"]
    assert "generator/histogram_loss" in out["metrics"]["histogram"]
    assert "generator/segmentation_loss" in out["metrics"]["indexed"]
    assert "discriminator/total_loss" in out["metrics"]["indexed"]


def _imported_modules(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def test_port_sources_import_nothing_of_the_jax_package():
    sources = glob.glob(os.path.join(REPO, "palette_and_histo_gan_tpu_torch", "**", "*.py"),
                        recursive=True)
    sources.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(sources) > 20
    for module in ("convert_weights.py", "utils/flops.py", "utils/profiling.py",
                   "models/convert.py"):
        assert os.path.join(REPO, "palette_and_histo_gan_tpu_torch", module) in sources, module
    bad = {
        os.path.relpath(path, REPO): sorted(
            m for m in _imported_modules(path)
            if any(m == f or m.startswith(f + ".") for f in FORBIDDEN)
        )
        for path in sources
    }
    assert {k: v for k, v in bad.items() if v} == {}
