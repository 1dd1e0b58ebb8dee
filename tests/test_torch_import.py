"""The PyTorch port runs without JAX.

In a fresh interpreter: import the port, train one step of a narrow
histogram-variant Trainer on the CPU (plain augmentation, since the batch
lies on the CPU), and check that no `jax` module was loaded and that the
CUDA augmentation kernel was launched no time.
"""

import json
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROGRAM = textwrap.dedent(
    """
    import json, math, sys

    import palette_and_histo_gan_tpu_torch as port
    from palette_and_histo_gan_tpu_torch.data import datasets_from_arrays, synthetic_arrays
    from palette_and_histo_gan_tpu_torch.ops import augment_kernel
    from palette_and_histo_gan_tpu_torch.train.trainer import Trainer

    config = port.config_for_variant(
        "histogram", down_filters=(8,) * 6, up_filters=(8,) * 6,
        batch_size=2, dataset_sizes=(8,), temp_folder=sys.argv[1],
    )
    trainer = Trainer(config, "cpu", datasets_from_arrays(*synthetic_arrays(config, 0), "cpu"))
    trainer.fit(steps=1, update_steps=1, callbacks=["evaluate_l1"])
    print(json.dumps({
        "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
        "launches": augment_kernel.launches,
        "step": trainer.state.step,
        "finite": all(math.isfinite(v) for v in trainer.history[0].values()),
        "metrics": sorted(trainer.history[0]),
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
    assert out["jax"] == []
    assert out["launches"] == {"packed": 0, "rgba": 0}
    assert out["step"] == 1 and out["finite"]
    assert "generator/histogram_loss" in out["metrics"]
    assert "discriminator/total_loss" in out["metrics"]
