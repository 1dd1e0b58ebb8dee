"""The port's data parallelism (palette_and_histo_gan_tpu_torch/parallel/) on
the CPU: two Gloo ranks, started by the package's own launcher
(parallel/launch.py) in one fan-out that runs every scenario, against one
process and against the JAX package:

  * 2 ranks equal 1 process (the port against itself): three steps at
    global batch 4 of baseline with augmentation and dropout on (the
    global draws), histogram under "xla"/"tri" and under "pallas2" (the
    kernels' plain versions), and indexed; losses within rtol 1e-4 /
    atol 1e-6, parameters within rtol 2e-3 / atol 1e-4
    (tests/test_parallel.py's limits for the JAX DP chunk), both ranks'
    parameters bit-equal;
  * the control: the Hellinger loss of each rank's own rows, the fault a
    naive port makes, reads about sqrt(2) times the one-process value, far
    outside the tolerance;
  * the slice against JAX: a 2-rank step of the port against JAX's
    make_dp_train_step on a 2-device mesh of the virtual CPU devices, from
    the same bridged weights on the same uint8 batches (deterministic
    dropout, no augmentation), baseline-no-aug and histogram, three steps:
    losses within rtol 1e-4, the parameter deltas as
    tests/test_torch_train_step.py holds them;
  * the data-parallel generate, dropout on, equals generate for n = 6, 8
    and 44: the indexed maps exactly, the RGBA fakes within
    GENERATE_ATOL; FidEvaluator(group=) gives the unsharded
    activations with batch_size 11 rounded up to 12;
  * a 2-rank Trainer fit(4, update_steps=2) with evaluate_l1 equals the
    one-process fit, only rank 0 wrote, and a 2-rank run resumed from a
    2-step run's checkpoint equals the uninterrupted one bit for bit;
  * measure_baseline under 2 ranks (baseline-no-aug and histogram, one
    epoch of 13 narrow steps, FID at input 75): L1s and FIDs within the
    parameters' rtol 2e-3 (no atol) of one process's record, the same
    on both ranks, `world_size` 2; rank 0 wrote the record, the previews
    and the checkpoints, and rank 1 left nothing in its working directory;
  * the refusals and the knobs: a batch of 3 over 2 ranks raises (in the
    Trainer and in measure_baseline);
    data_parallel="on" without a process group forms a world of one,
    which trains as one device does; check_supported takes every mode;
    the CLI's --data-parallel.
"""

from __future__ import annotations

import concurrent.futures
import glob
import inspect
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from palette_and_histo_gan_tpu.parallel import dp as jdp
from palette_and_histo_gan_tpu.parallel import mesh as jmesh
from palette_and_histo_gan_tpu_torch import check_supported, cli, measure_baseline, ref_regime
from palette_and_histo_gan_tpu_torch import config as tconfig
from palette_and_histo_gan_tpu_torch.data import loader
from palette_and_histo_gan_tpu_torch.eval.fid import FidEvaluator
from palette_and_histo_gan_tpu_torch.models import convert
from palette_and_histo_gan_tpu_torch.models.convert import flatten_tree
from palette_and_histo_gan_tpu_torch.ops import histogram as hist_ops
from palette_and_histo_gan_tpu_torch.parallel import distributed
from palette_and_histo_gan_tpu_torch.parallel.launch import build_parser as launch_parser
from palette_and_histo_gan_tpu_torch.parallel.launch import launch
from palette_and_histo_gan_tpu_torch.parallel.mesh import make_group
from palette_and_histo_gan_tpu_torch.train.state import create_train_state
from palette_and_histo_gan_tpu_torch.train.steps import generate, make_train_step
from palette_and_histo_gan_tpu_torch.train.trainer import Trainer
from tests.test_torch_train_step import NARROW, configs, same_init_states

WORLD = 2
BATCH = 4
STEPS = 3
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=2e-3, atol=1e-4)
SELF_CASES = {
    "baseline": {},
    "histogram-xla": {"model": "histogram"},
    "histogram-pallas2": {"model": "histogram", "histogram_impl": "pallas2"},
    "indexed": {"model": "indexed"},
}
JAX_CASES = ("baseline-no-aug", "histogram")
GENERATE_SIZES = (6, 8, 44)
# the [-1, 1] fakes of the data-parallel generate against generate's: the
# convolutions of n / 2 rows and of n rows sum in other orders (oneDNN picks
# its kernels by shape); a row given another row's dropout masks is off by
# tenths
GENERATE_ATOL = 1e-5
FID = dict(input_size=75, reference_quirks=False)  # FidEvaluator's batch_size 11
FIT = dict(NARROW, model="baseline", batch_size=BATCH, dataset_sizes=(20,))
# measure_baseline on the first 60 pairs of a synthetic root (51 train, 9
# test: 13 steps an epoch), as tests/test_torch_measure_baseline.py runs it
BASELINE = dict(variants=["baseline-no-aug", "histogram"], epochs=1, fid_input_size=75)
BASELINE_NARROW = dict(NARROW, dataset_sizes=(60,))
BASELINE_VALUES = ("l1_train", "l1_test", "fid_train", "fid_test")
# PARAM_TOL's rtol alone: the FIDs of random Inception features at input 75
# are ~5e-4, under its atol (2 ranks vs 1 process: ~2e-4 relative at most)
BASELINE_TOL = dict(rtol=PARAM_TOL["rtol"], atol=0)


def make_config(kwargs: dict) -> tconfig.Config:
    kwargs = dict(kwargs)
    return tconfig.config_for_variant(kwargs.pop("model"), **kwargs)


def self_config(case: str) -> dict:
    return dict(NARROW, **{"model": "baseline", **SELF_CASES[case]})


def batches(indexed: bool, seed: int) -> list:
    """STEPS global (source, target) batches: uint8 RGBA, or int32 index maps."""
    rng = np.random.default_rng(seed)
    shape, high, dtype = ((BATCH, 64, 64, 1), 256, np.int32) if indexed else \
        ((BATCH, 64, 64, 4), 256, np.uint8)
    return [tuple(torch.from_numpy(rng.integers(0, high, shape).astype(dtype)) for _ in range(2))
            for _ in range(STEPS)]


def generate_sources(indexed: bool) -> list:
    rng = np.random.default_rng(31)
    if indexed:
        return [torch.from_numpy(rng.integers(0, 256, (n, 64, 64, 1)).astype(np.int32))
                for n in GENERATE_SIZES]
    return [torch.from_numpy(rng.uniform(-1, 1, (n, 64, 64, 4)).astype(np.float32))
            for n in GENERATE_SIZES]


def fid_images() -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(41).uniform(0, 255, (22, 64, 64, 4))
                            .astype(np.float32))


def jax_setup(variant: str):
    """The JAX and port configs of a JAX case, the JAX models and state
    from PRNGKey(0), and those weights bridged to the port."""
    jax_config, config = configs(variant, deterministic_dropout=True, augment_probability=0.0,
                                 donate_state=False, batch_size=BATCH, **NARROW)
    models, jax_state, state = same_init_states(jax_config, config)
    weights = {"generator": state.generator.state_dict(),
               "discriminator": state.discriminator.state_dict()}
    return jax_config, models, jax_state, weights


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread and one BLAS thread in this process while the file
    runs, as in each rank: the suite runs several test processes on the
    host's cores at once, and a thread a core in each makes them contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world(one_thread, tmp_path_factory):
    """One 2-rank fan-out running every scenario of the file, started in a
    thread so that the tests' own references run meanwhile; returns
    (future of results[rank][scenario], the scenarios' indices by name,
    the fit scenarios' folder)."""
    root = tmp_path_factory.mktemp("ranks")
    scenarios, index = [], {}

    def add(name, kind, **kwargs):
        index[name] = len(scenarios)
        scenarios.append((kind, kwargs))

    for case in SELF_CASES:
        add(f"self/{case}", "steps", config=self_config(case),
            batches=batches(case == "indexed", seed=1))
    for variant in JAX_CASES:
        jax_config, _, _, weights = jax_setup(variant)
        add(f"jax/{variant}", "steps", config=dict(NARROW, model=variant, batch_size=BATCH,
                                                   deterministic_dropout=True,
                                                   augment_probability=0.0),
            batches=batches(False, seed=2), weights=weights)
    for variant in ("baseline-no-aug", "indexed"):
        add(f"generate/{variant}", "generate", config=dict(NARROW, model=variant),
            sources=generate_sources(variant == "indexed"), dropout_seed=5)
    add("fid", "fid", images=fid_images(), **FID)
    fit = dict(config=FIT, steps=4, update_steps=2, callbacks=("evaluate_l1",))
    add("fit", "fit", **dict(fit, config=dict(FIT, temp_folder=str(root / "fit" / "rank{rank}"))))
    shared = dict(FIT, temp_folder=str(root / "resume"))
    add("fit/first-half", "fit", config=shared, steps=2, update_steps=2)
    add("fit/resumed", "fit", config=shared, steps=2, update_steps=2, resume=True)
    add("refusal/batch-3", "fit", config=dict(FIT, batch_size=3, temp_folder=str(root / "r")),
        steps=1, update_steps=1)
    baseline = dict(BASELINE, data_root=ref_regime.write_synthetic_root(str(root / "dataset")))
    add("measure_baseline", "measure_baseline", workdir=str(root / "baseline" / "rank{rank}"),
        config=BASELINE_NARROW, **baseline)
    add("refusal/measure_baseline-batch-3", "measure_baseline",
        workdir=str(root / "baseline-3" / "rank{rank}"),
        config=dict(BASELINE_NARROW, batch_size=3), **baseline)

    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(launch, WORLD, scenarios, "cpu", None, 600.0)
    yield future, index, root
    pool.shutdown(wait=True)


def result(world, name: str) -> list[dict]:
    """Each rank's result of scenario `name`; a rank's error fails the test."""
    future, index, _ = world
    out = [rank_results[index[name]] for rank_results in future.result()]
    for rank, r in enumerate(out):
        assert "error" not in r, f"rank {rank}: {r['error']}"
        assert not r["jax_loaded"], f"rank {rank} imported jax"
    return out


def assert_state_dicts_close(ours: dict, ref: dict, **tol) -> None:
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_allclose(ours[k].numpy(), v.numpy(), err_msg=k, **tol)


def one_process_steps(config: dict, steps_batches: list) -> tuple[list[dict], object]:
    cfg = make_config(config)
    state = create_train_state(cfg, "cpu", 0)
    step = make_train_step(cfg)
    metrics = [{k: float(v) for k, v in step(state, s, t).items()} for s, t in steps_batches]
    return metrics, state


# ---------------------------------------------------------- 2 ranks = 1


@pytest.mark.parametrize("case", list(SELF_CASES))
def test_two_ranks_equal_one_process(world, case):
    ref_metrics, ref_state = one_process_steps(self_config(case),
                                               batches(case == "indexed", seed=1))
    ranks = result(world, f"self/{case}")
    for r in ranks:
        assert r["step"] == STEPS
        for ours, ref in zip(r["metrics"], ref_metrics):
            assert ours.keys() == ref.keys()
            for k in ref:
                np.testing.assert_allclose(ours[k], ref[k], err_msg=k, **LOSS_TOL)
    for which, module in (("generator", ref_state.generator),
                          ("discriminator", ref_state.discriminator)):
        assert_state_dicts_close(ranks[0][which], module.state_dict(), **PARAM_TOL)
        # the ranks hold one set of parameters, bit for bit
        assert all(torch.equal(ranks[0][which][k], ranks[1][which][k]) for k in ranks[0][which])


def test_per_rank_hellinger_is_sqrt_world_off():
    """The control: the Hellinger loss of each rank's own rows, averaged as
    the metrics are, against the global one on the first step's real and
    fake histograms. The sum of squares of B/N images is about 1/N of the
    whole batch's, and dividing by B/N instead of B gives sqrt(N) in all."""
    cfg = make_config(self_config("histogram-xla"))
    state = create_train_state(cfg, "cpu", 0)
    source, target = batches(False, seed=1)[0]
    src = source.float() / 127.5 - 1.0
    tgt = target.float() / 127.5 - 1.0
    with torch.no_grad():
        fake = state.generator(src, deterministic=True)
        real_h, fake_h = (hist_ops.calculate_rgbuv_histogram(x) for x in (tgt, fake))
    whole = float(hist_ops.hellinger_loss(real_h, fake_h))
    half = BATCH // WORLD
    per_rank = np.mean([float(hist_ops.hellinger_loss(real_h[i:i + half], fake_h[i:i + half]))
                        for i in range(0, BATCH, half)])
    assert abs(per_rank / whole - math.sqrt(WORLD)) < 0.05 * math.sqrt(WORLD)
    assert not np.isclose(per_rank, whole, **LOSS_TOL)


# ------------------------------------------------------- against JAX


@pytest.mark.parametrize("variant", JAX_CASES)
def test_dp_step_matches_jax_dp_step(world, variant):
    jax_config, models, jax_state, weights = jax_setup(variant)
    mesh = jmesh.make_mesh(jax.devices()[:WORLD])
    jax_step = jdp.make_dp_train_step(jax_config, models, mesh)
    state0 = jax_state
    jax_state = jmesh.replicate_state(mesh, jax_state)
    jax_metrics = []
    for source, target in batches(False, seed=2):
        src, tgt = (jmesh.shard_batch(mesh, jnp.asarray(x.numpy())) for x in (source, target))
        jax_state, m = jax_step(jax_state, src, tgt)
        jax_metrics.append({k: float(v) for k, v in m.items()})
    rank0 = result(world, f"jax/{variant}")[0]
    for ours, ref in zip(rank0["metrics"], jax_metrics):
        assert sorted(ours) == sorted(ref)
        for k in ref:
            np.testing.assert_allclose(ours[k], ref[k], rtol=1e-4, err_msg=k)
    # the parameter deltas of tests/test_torch_train_step.py
    cfg = tconfig.config_for_variant(variant, **NARROW)
    state = create_train_state(cfg, "cpu", 0)
    for which, net, to_sd in (("generator", state.generator,
                               convert.generator_state_dict_from_flax),
                              ("discriminator", state.discriminator,
                               convert.discriminator_state_dict_from_flax)):
        tree0 = jax.tree_util.tree_map(np.asarray, getattr(state0, f"{which[0]}_params"))
        tree1 = jax.tree_util.tree_map(np.asarray, getattr(jax_state, f"{which[0]}_params"))
        ref0, ref1 = to_sd(tree0, net), to_sd(tree1, net)
        for k, w in rank0[which].items():
            delta = (w - weights[which][k]).numpy()
            ref = (ref1[k] - ref0[k]).numpy()
            assert np.linalg.norm(delta - ref) <= 1e-3 * np.linalg.norm(ref), k


# ------------------------------------------------- generate and FID


@pytest.mark.parametrize("variant", ["baseline-no-aug", "indexed"])
def test_dp_generate_equals_generate(world, variant):
    cfg = tconfig.config_for_variant(variant, **NARROW)
    state = create_train_state(cfg, "cpu", 0)
    drop = torch.Generator()
    drop.manual_seed(5)
    ref = [generate(cfg, state.generator, s, drop) for s in generate_sources(cfg.is_indexed)]
    for r in result(world, f"generate/{variant}"):
        for n, ours, want in zip(GENERATE_SIZES, r["outputs"], ref):
            assert ours.shape == want.shape and ours.dtype == want.dtype, n
            if cfg.is_indexed:
                assert torch.equal(ours, want), n
            else:
                err = float((ours - want).abs().max())
                assert err <= GENERATE_ATOL, n


def test_sharded_fid_activations_equal_unsharded(world, monkeypatch):
    monkeypatch.delenv("PHG_INCEPTION_WEIGHTS", raising=False)
    want = FidEvaluator(device="cpu", **FID).activations(fid_images())
    scale = float(want.abs().max())
    for r in result(world, "fid"):
        assert r["batch_size"] == 12
        assert r["activations"].shape == want.shape == (22, 2048)
        np.testing.assert_allclose(r["activations"].numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5 * scale)


# ------------------------------------------------------------ Trainer


def one_process_fit(tmp_path) -> Trainer:
    cfg = make_config(dict(FIT, temp_folder=str(tmp_path), data_parallel="off"))
    trainer = Trainer(cfg, "cpu", loader.datasets_from_arrays(*loader.synthetic_arrays(cfg, 3),
                                                              "cpu"))
    trainer.fit(4, update_steps=2, callbacks=["evaluate_l1"])
    return trainer


def test_two_rank_fit_equals_one_process_and_only_rank_0_writes(world, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ref = one_process_fit(tmp_path / "one")
    ranks = result(world, "fit")
    for r in ranks:
        assert len(r["history"]) == len(ref.history) == 4
        for ours, want in zip(r["history"], ref.history):
            for k in want:
                np.testing.assert_allclose(ours[k], want[k], err_msg=k, **LOSS_TOL)
        np.testing.assert_allclose(r["l1"], ref.report_l1(), **LOSS_TOL)
    assert [r["writes"] for r in ranks] == [True, False]
    assert ranks[0]["history"] == ranks[1]["history"]
    _, _, root = world
    assert not (root / "fit" / "rank1").exists()
    rank0 = root / "fit" / "rank0"
    runs = glob.glob(str(rank0 / "logs" / "front-to-right" / "baseline" / "*"))
    assert len(runs) == 1
    writers = glob.glob(os.path.join(runs[0], "events.out.tfevents.*"))
    writers += glob.glob(os.path.join(runs[0], "metrics.jsonl"))  # without tensorboardX
    assert len(writers) == 1
    previews = sorted(os.path.basename(p) for p in glob.glob(os.path.join(runs[0], "step_*.png")))
    assert previews == ["step_000000.png", "step_000002.png", "step_000004.png"]
    checkpoints = glob.glob(str(rank0 / "training-checkpoints" / "*" / "*" / "step_*.pt"))
    assert [os.path.basename(p) for p in checkpoints] == ["step_000000004.pt"]


def test_two_rank_resume_equals_uninterrupted(world):
    whole = result(world, "fit")[0]
    first = result(world, "fit/first-half")
    resumed = result(world, "fit/resumed")
    assert all(r["starting_step"] == 2 for r in resumed)
    assert [r["history"] for r in first] == [whole["history"][:2]] * WORLD
    ours, theirs = flatten_tree(resumed[0]["state"]), flatten_tree(whole["state"])
    assert ours.keys() == theirs.keys()
    for key, value in ours.items():
        if isinstance(value, torch.Tensor):
            assert torch.equal(value, theirs[key]), key
        else:
            assert value == theirs[key], key
    assert resumed[0]["history"] == resumed[1]["history"] == whole["history"][2:]


def test_two_rank_measure_baseline_equals_one_process_and_only_rank_0_writes(world, tmp_path,
                                                                          monkeypatch):
    monkeypatch.chdir(tmp_path)
    _, _, root = world
    want = measure_baseline.measure(
        BASELINE["variants"], BASELINE["epochs"], "cpu", data_root=str(root / "dataset"),
        temp_folder=str(tmp_path / "temp"), fid_input_size=BASELINE["fid_input_size"],
        **BASELINE_NARROW)
    assert want["world_size"] == 1
    ranks = result(world, "measure_baseline")
    for r in ranks:
        got = r["record"]
        assert got["world_size"] == WORLD and got["epochs"] == 1
        assert [e["variant"] for e in got["results"]] == BASELINE["variants"]
        for ours, ref in zip(got["results"], want["results"]):
            for key in ("variant", "architecture", "steps", "batch_size", "histogram_impl",
                        "fid_weights", "launches"):
                assert ours[key] == ref[key], key
            assert ours["steps"] == 13 and ours["batch_size"] == BATCH
            for key in BASELINE_VALUES:
                assert math.isfinite(ours[key]), key
                np.testing.assert_allclose(ours[key], ref[key], err_msg=key, **BASELINE_TOL)
    # the ranks report one set of values
    assert [[e[k] for k in BASELINE_VALUES] for e in ranks[0]["record"]["results"]] == [
        [e[k] for k in BASELINE_VALUES] for e in ranks[1]["record"]["results"]]
    rank0, rank1 = (r["files"] for r in ranks)
    assert os.path.join("build", "baseline_results.json") in rank0
    assert any(f.endswith(".png") for f in rank0) and any(f.endswith(".pt") for f in rank0)
    assert rank1 == []


# ------------------------------------------------ refusals and knobs


@pytest.mark.parametrize("scenario", ["refusal/batch-3", "refusal/measure_baseline-batch-3"])
def test_batch_that_does_not_split_over_the_ranks_raises(world, scenario):
    future, index, _ = world
    for rank_results in future.result():
        error = rank_results[index[scenario]].get("error", "")
        assert error.startswith("ValueError") and "does not split over 2" in error


def test_on_without_a_process_group_forms_a_world_of_one(tmp_path, monkeypatch):
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert not torch.distributed.is_initialized()
    trainers = []
    try:
        for mode in ("on", "off"):
            cfg = make_config(dict(FIT, temp_folder=str(tmp_path / mode), data_parallel=mode))
            datasets = loader.datasets_from_arrays(*loader.synthetic_arrays(cfg, 3), "cpu")
            trainers.append(Trainer(cfg, "cpu", datasets))
            trainers[-1].fit(2, update_steps=2)
        on, off = trainers
        assert (on.group.world_size, on.group.rank) == (1, 0) and off.group is None
        assert distributed.global_mesh_info()["backend"] == "gloo"
        assert on.history == off.history
    finally:
        distributed.shutdown()
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("mode", ["auto", "on", "off"])
def test_check_supported_takes_every_data_parallel_mode(mode):
    config = tconfig.config_for_variant("histogram", data_parallel=mode)
    for device in ("cpu", "cuda"):
        check_supported(config, device)


def test_cli_parses_data_parallel():
    parser = cli.build_parser()
    assert parser.parse_args([]).data_parallel == "auto"
    for mode in ("auto", "on", "off"):
        args = parser.parse_args(["--data-parallel", mode])
        assert cli.config_from_args(args).data_parallel == mode
    assert parser._option_string_actions["--data-parallel"].choices == ["auto", "on", "off"]
    with pytest.raises(SystemExit):
        parser.parse_args(["--data-parallel", "sometimes"])


def test_rank_device_under_torchrun(monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert distributed.rank_device("cuda") == torch.device("cuda", 3)
    assert distributed.rank_device("cuda:0") == torch.device("cuda", 0)
    assert distributed.rank_device("cpu") == torch.device("cpu")
    monkeypatch.delenv("LOCAL_RANK")
    assert distributed.rank_device("cuda") == torch.device("cuda")


def test_launcher_and_group_default_to_the_card():
    assert inspect.signature(launch).parameters["device"].default == "cuda"
    args = launch_parser().parse_args(
        ["--rank", "0", "--world-size", "2", "--dir", "d"])
    assert args.device == "cuda"
    for fn in (distributed.initialize, make_group):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
