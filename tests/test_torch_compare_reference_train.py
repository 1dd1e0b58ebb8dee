"""The port's training-quality comparison
(`palette_and_histo_gan_tpu_torch/compare_reference_train.py`) against
`scripts/compare_reference_train.py`, at narrow widths on the CPU.

* `train` against the JAX script's `train` on the same synthetic dataset
  root (written by the port's `ref_regime.write_synthetic_root`; the JAX
  side reads it through PHG_DATA_ROOT): 6 steps with an eval every 3, for
  baseline-no-aug and indexed, at 8 filters a stage (both converters'
  stage widths and both `config_for_variant`s patched, as
  tests/test_torch_trajectory.py::run_loop patches them). The curves
  agree within TestTrajectoryParity's rtols (1e-3; adversarial and
  segmentation 2e-3), the eval L1s within 1e-3, and the record's keys are
  the JAX record's plus the port's `host_ms_per_step`, `histogram_impl`
  and `data_root`.
* `compare` prints the table for a record of the same regime, and `main`
  prints "not comparing" for another; `--fid-at` without the shared-init
  Inception weights raises; without a card and without `--device cpu`
  the command exits with a message.
"""

import functools
import json
import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from palette_and_histo_gan_tpu import config as jconfig
from palette_and_histo_gan_tpu.models import convert as jconvert
from palette_and_histo_gan_tpu_torch import compare_reference_train as crt
from palette_and_histo_gan_tpu_torch import config as tconfig
from palette_and_histo_gan_tpu_torch import ref_regime
from palette_and_histo_gan_tpu_torch.models import convert

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
if SCRIPTS not in sys.path:
    sys.path.insert(0, SCRIPTS)

import compare_reference_train as jcrt  # noqa: E402

NARROW = dict(down_filters=(8,) * 6, up_filters=(8,) * 6)
STEPS, EVAL_EVERY = 6, 3
# TestTrajectoryParity's per-step rtols, by the records' curve names
CURVE_RTOL = {"g_total": 1e-3, "d_total": 1e-3, "g_adv": 2e-3, "g_l1": 1e-3,
              "segmentation": 2e-3}
EVAL_RTOL = 1e-3
PORT_KEYS = {"host_ms_per_step", "histogram_impl", "data_root"}


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
def root(tmp_path_factory):
    return ref_regime.write_synthetic_root(str(tmp_path_factory.mktemp("regime") / "dataset"))


@pytest.fixture(scope="module")
def narrow():
    """Both packages' configs and converters at 8 filters a stage."""
    with mock.patch.multiple(jconvert, DOWN_FILTERS=NARROW["down_filters"],
                             UP_FILTERS=NARROW["up_filters"]), \
            mock.patch.multiple(convert, DOWN_FILTERS=NARROW["down_filters"],
                                UP_FILTERS=NARROW["up_filters"]), \
            mock.patch.object(jconfig, "config_for_variant",
                              functools.partial(jconfig.config_for_variant, **NARROW)), \
            mock.patch.object(crt, "config_for_variant",
                              functools.partial(tconfig.config_for_variant, **NARROW)):
        yield


@pytest.fixture(scope="module")
def runs(root, narrow):
    """{variant: (port record, JAX record)}, 6 narrow steps each."""
    out = {}
    with mock.patch.dict(os.environ, {"PHG_DATA_ROOT": root}):
        for variant in ("baseline-no-aug", "indexed"):
            want = jcrt.train(variant, STEPS, EVAL_EVERY)
            got = crt.train(variant, STEPS, EVAL_EVERY, root=root, device="cpu")
            out[variant] = got, want
    return out


@pytest.mark.parametrize("variant", ["baseline-no-aug", "indexed"])
def test_train_matches_the_jax_script(runs, variant):
    got, want = runs[variant]
    assert set(got["curves"]) == set(want["curves"])
    for name, values in want["curves"].items():
        assert len(got["curves"][name]) == STEPS
        np.testing.assert_allclose(got["curves"][name], values, rtol=CURVE_RTOL[name],
                                   err_msg=f"{variant} {name}")
    assert got["eval_steps"] == want["eval_steps"] == [1, 3, 6]
    np.testing.assert_allclose(got["eval_l1"], want["eval_l1"], rtol=EVAL_RTOL)
    assert all(np.isfinite(got["eval_l1"]))


@pytest.mark.parametrize("variant", ["baseline-no-aug", "indexed"])
def test_record_has_the_jax_keys_and_the_ports(runs, root, variant):
    got, want = runs[variant]
    assert set(got) == set(want) | PORT_KEYS
    for key in ("variant", "steps", "batch", "dropout"):
        assert got[key] == want[key]
    assert got["framework"].startswith(f"torch-{torch.__version__} (cpu")
    assert got["histogram_impl"] == "xla" and got["data_root"] == root
    assert 0 < got["host_ms_per_step"] < 1e3 * got["wall_seconds"] / STEPS


@pytest.mark.parametrize("impl", [None, "pallas2"])
def test_regime_config_takes_the_histogram_impl_or_the_devices(root, impl):
    """The regime's histogram follows the CLI's choice on the device unless
    the caller names one (the card's "pallas2" runs its plain versions on
    CPU tensors)."""
    config = crt.regime_config("histogram", "cpu", root, impl)
    assert config.histogram_impl == (impl or "xla")
    assert config.deterministic_dropout and config.augment_probability == 0.0


def test_compare_prints_the_table_for_the_same_regime(runs, capsys):
    got, want = runs["baseline-no-aug"]
    crt.compare(got, want)
    out = capsys.readouterr().out
    assert "G loss    windows:" in out and "test L1 curve:" in out
    assert out.count("  step ") == 3


def test_main_does_not_compare_another_regime(root, narrow, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    reference = tmp_path / "reference.json"
    reference.write_text(json.dumps({"variant": "baseline-no-aug", "steps": 1000}))
    assert crt.main(["--steps", "5", "--eval-every", "5", "--data-root", root, "--device", "cpu",
                     "--reference", str(reference), "--out", "build/r.json"]) == 0
    out = capsys.readouterr().out
    assert "different regime; not comparing" in out
    record = json.loads((tmp_path / "build" / "r.json").read_text())
    assert record["steps"] == 5 and record["eval_steps"] == [1, 5]


def test_fid_at_needs_the_shared_inception_weights(root, tmp_path):
    with pytest.raises(FileNotFoundError, match="--inception-npz"):
        crt.train("baseline-no-aug", 2, 2, fid_at=[2], root=root, device="cpu")
    with pytest.raises(FileNotFoundError, match="--inception-npz"):
        crt.train("baseline-no-aug", 2, 2, fid_at=[2], root=root, device="cpu",
                  inception_npz=str(tmp_path / "missing.npz"))
    with pytest.raises(ValueError, match="no FID curve"):
        crt.train("indexed", 2, 2, fid_at=[2], root=root, device="cpu")


def test_without_a_card_the_command_exits_with_a_message():
    assert not torch.cuda.is_available()
    with pytest.raises(SystemExit, match="no CUDA device"):
        crt.main(["--steps", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        crt.train("baseline-no-aug", 2, 2, device="cuda")


def test_fid_at_reports_both_distances_on_the_named_weights(root, narrow, tmp_path, monkeypatch):
    """With a weight file, the FID curve: the scipy formula and the port's
    low-rank distance at each step of `fid_at` (one step: scipy's sqrtm of
    a 2048 x 2048 product takes seconds; the Inception at input 75 here, as
    tests/test_torch_export.py sizes it)."""
    from palette_and_histo_gan_tpu_torch.eval import fid
    from palette_and_histo_gan_tpu_torch.models import inception

    npz = tmp_path / "inception_shared.npz"
    np.savez(npz, **inception.random_flat_params(inception.InceptionV3(), seed=3))
    monkeypatch.setattr(fid, "FidEvaluator", functools.partial(fid.FidEvaluator, input_size=75))
    monkeypatch.delenv("PHG_INCEPTION_WEIGHTS", raising=False)
    record = crt.train("baseline-no-aug", 5, 5, fid_at=[5], root=root, device="cpu",
                       inception_npz=str(npz))
    assert record["fid_steps"] == [5]
    assert record["fid_features"] == "shared-init InceptionV3 (inception_shared.npz)"
    assert all(np.isfinite(record["fid"])) and all(v > 0 for v in record["fid_lowrank"])
    np.testing.assert_allclose(record["fid_lowrank"], record["fid"], rtol=1e-3)
    assert "PHG_INCEPTION_WEIGHTS" not in os.environ
