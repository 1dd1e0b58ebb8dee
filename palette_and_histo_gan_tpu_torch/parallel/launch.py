"""A local world of data-parallel ranks, each running named scenarios.

    results = launch(2, [("steps", {...}), ("generate", {...})], device="cpu")
    results[rank][i]  # rank's result of the i-th scenario

`launch` starts one process a rank
(`python -m palette_and_histo_gan_tpu_torch.parallel.launch`), joined on a
file rendezvous in a temporary directory, runs the scenarios in order in
every rank and returns each rank's results: dicts of numbers, strings,
lists and tensors, written with torch.save. A scenario that raises gives
{"error": "..."} on its rank and the next one runs. The ranks take the
caller's numeric settings (TF32, deterministic cuDNN, oneDNN) and one CPU
thread each (RANK_THREADS), and import nothing of JAX.

Devices: "cuda", the default, for one card a rank (cuda:<rank>, NCCL);
"cuda:0" for ranks that share one card over Gloo (`backend="gloo"`);
"cpu" (Gloo) when the caller asks for the CPU.

The scenarios are the data-parallel paths a rank runs, fed from seeds or
from tensors the caller hands over:
  * "steps": make_dp_train_step on given global batches, from the state of
    `seed` or given weights; per-step metrics and the final weights;
  * "generate": make_dp_generate_fn on given sources, dropout on;
  * "fid": FidEvaluator(group=) activations;
  * "fit": a Trainer with data_parallel="on" on seeded synthetic sprites,
    optionally restored from its checkpoint, fit with callbacks; the
    history, the L1 report, the state and the kernels' launches;
  * "measure_baseline": measure_baseline.measure in a working directory of
    the rank's own; the record and the files the rank left there.
"""

from __future__ import annotations

import argparse
import datetime
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import torch

PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# CPU threads a rank: the ranks share the host's cores, and a rank on a card
# only launches work
RANK_THREADS = 1


def numeric_settings() -> dict:
    """The caller's settings that change a result's bits."""
    return {
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "cudnn_deterministic": torch.backends.cudnn.deterministic,
        "cudnn_benchmark": torch.backends.cudnn.benchmark,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
        "mkldnn": torch.backends.mkldnn.enabled,
    }


def apply_numeric_settings(s: dict) -> None:
    torch.backends.cudnn.allow_tf32 = s["cudnn_allow_tf32"]
    torch.backends.cudnn.deterministic = s["cudnn_deterministic"]
    torch.backends.cudnn.benchmark = s["cudnn_benchmark"]
    torch.backends.cuda.matmul.allow_tf32 = s["matmul_allow_tf32"]
    torch.set_float32_matmul_precision(s["float32_matmul_precision"])
    torch.backends.mkldnn.enabled = s["mkldnn"]


def launch(world_size: int, scenarios: list, device: str = "cuda", backend: str | None = None,
           timeout: float = 600.0) -> list[list[dict]]:
    """Run `scenarios`, a list of (name, kwargs), in `world_size` ranks on
    `device`; returns results[rank][scenario]. Raises if a rank fails
    outside its scenarios or the world outlives `timeout` seconds (every
    rank is then killed)."""
    workdir = tempfile.mkdtemp(prefix="phg-ranks-")
    try:
        torch.save({"scenarios": scenarios, "settings": numeric_settings()},
                   os.path.join(workdir, "job.pt"))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (PACKAGE_PARENT, env.get("PYTHONPATH")) if p
        )
        procs = []
        for rank in range(world_size):
            env["LOCAL_RANK"] = str(rank)
            cmd = [sys.executable, "-m", "palette_and_histo_gan_tpu_torch.parallel.launch",
                   "--rank", str(rank), "--world-size", str(world_size), "--dir", workdir,
                   "--device", device, "--timeout", str(timeout)]
            if backend:
                cmd += ["--backend", backend]
            log = open(os.path.join(workdir, f"rank{rank}.log"), "w")
            procs.append(subprocess.Popen(cmd, env=dict(env), stdout=log,
                                          stderr=subprocess.STDOUT))
            log.close()
        deadline = time.monotonic() + timeout
        try:
            for proc in procs:
                proc.wait(timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"the ranks outlived {timeout} s:\n{_logs(workdir, world_size)}")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if any(proc.returncode for proc in procs):
            codes = [proc.returncode for proc in procs]
            raise RuntimeError(f"ranks exited {codes}:\n{_logs(workdir, world_size)}")
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=True)
                for r in range(world_size)]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _logs(workdir: str, world_size: int) -> str:
    out = []
    for rank in range(world_size):
        with open(os.path.join(workdir, f"rank{rank}.log")) as f:
            out.append(f"--- rank {rank}\n{f.read()[-4000:]}")
    return "\n".join(out)


# ----------------------------------------------------------------- scenarios


def _config(kwargs: dict):
    from ..config import config_for_variant

    kwargs = dict(kwargs)
    return config_for_variant(kwargs.pop("model"), **kwargs)


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def scenario_steps(group, config: dict, batches: list, weights: dict | None = None) -> dict:
    """make_dp_train_step over `batches`, a list of global (source, target)
    batches, from create_train_state(seed 0) or `weights` (generator and
    discriminator state_dicts)."""
    from ..parallel.dp import make_dp_train_step
    from ..parallel.mesh import replicate_state, shard_batch
    from ..train.state import create_train_state

    cfg = _config(config)
    state = create_train_state(cfg, group.device, 0)
    if weights is not None:
        state.generator.load_state_dict(weights["generator"])
        state.discriminator.load_state_dict(weights["discriminator"])
    replicate_state(group, state)
    step = make_dp_train_step(cfg, group)
    metrics = []
    for source, target in batches:
        local = shard_batch(group, (source.to(group.device), target.to(group.device)))
        metrics.append({k: float(v) for k, v in step(state, *local).items()})
    return {"metrics": metrics, "step": state.step,
            "generator": _host(state.generator.state_dict()),
            "discriminator": _host(state.discriminator.state_dict())}


def scenario_generate(group, config: dict, sources: list, dropout_seed: int) -> dict:
    """make_dp_generate_fn on each of `sources` (dropout on), the
    generator of create_train_state(seed 0), one dropout generator seeded
    `dropout_seed` for all of them in order."""
    from ..parallel.dp import make_dp_generate_fn
    from ..train.state import create_train_state

    cfg = _config(config)
    state = create_train_state(cfg, group.device, 0)
    generate = make_dp_generate_fn(group)
    drop = torch.Generator(device=group.device)
    drop.manual_seed(dropout_seed)
    return {"outputs": [generate(cfg, state.generator, s.to(group.device), drop).cpu()
                        for s in sources]}


def scenario_fid(group, images: torch.Tensor, input_size: int = 299,
                 reference_quirks: bool = True) -> dict:
    """FidEvaluator(group=) activations of `images`, at its default batch
    size (random weights unless PHG_INCEPTION_WEIGHTS names converted
    ones)."""
    from ..eval.fid import FidEvaluator

    ev = FidEvaluator(reference_quirks=reference_quirks, input_size=input_size,
                      device=group.device, group=group)
    return {"batch_size": ev.batch_size, "activations": ev.activations(images).cpu()}


def scenario_fit(group, config: dict, steps: int, update_steps: int, data_seed: int = 3,
                 callbacks: tuple = (), resume: bool = False, warmup_steps: int = 0) -> dict:
    """A Trainer with data_parallel="on" on seeded synthetic sprites
    (`config["temp_folder"]` may name the rank as {rank}), restored from
    its newest checkpoint when `resume`, after `warmup_steps` steps of
    warm-up (whose history and times are dropped) fit(steps, update_steps,
    callbacks); the history, the L1 report, the state, the kernels'
    launches and the phase seconds of the fit."""
    from ..data import loader
    from ..ops import augment_kernel, histogram_kernel, palette_kernel
    from ..train.trainer import Trainer

    config = dict(config, data_parallel="on")
    config["temp_folder"] = config["temp_folder"].format(rank=group.rank)
    cfg = _config(config)
    if cfg.is_indexed:
        datasets = loader.indexed_datasets_from_arrays(
            *loader.synthetic_indexed_arrays(cfg, data_seed), group.device,
            cfg.palette_ordering, cfg.seed)
    else:
        datasets = loader.datasets_from_arrays(*loader.synthetic_arrays(cfg, data_seed),
                                               group.device)
    trainer = Trainer(cfg, group.device, datasets)
    starting_step = trainer.restore_latest_checkpoint() if resume else 0
    if warmup_steps:
        trainer.fit(warmup_steps, warmup_steps, starting_step=starting_step)
        starting_step += warmup_steps
        trainer.history.clear()
        trainer.phase_seconds.clear()
    counters = (augment_kernel, histogram_kernel, palette_kernel)
    for c in counters:
        c.reset_launches()
    trainer.fit(steps, update_steps, callbacks=list(callbacks), starting_step=starting_step)
    if group.device.type == "cuda":
        torch.cuda.synchronize(group.device)
    launches = {k: v for c in counters for k, v in c.launches.items()}
    return {"history": trainer.history, "starting_step": starting_step,
            "phase_seconds": dict(trainer.phase_seconds), "launches": launches,
            "l1": list(trainer.report_l1()), "state": _host(trainer.state.state_dict()),
            "writes": trainer.writes}


def scenario_measure_baseline(group, workdir: str, variants: list, epochs: int, data_root: str,
                              config: dict | None = None, fid_input_size: int = 299) -> dict:
    """measure_baseline.measure of `variants` from `data_root`, run in
    `workdir` (which may name the rank as {rank}) with the networks
    narrowed by `config`, the record to build/baseline_results.json there;
    the record and the files the rank left under `workdir`."""
    from .. import measure_baseline

    workdir = workdir.format(rank=group.rank)
    os.makedirs(workdir, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        record = measure_baseline.measure(
            variants, epochs, group.device, data_root=data_root,
            out=os.path.join("build", "baseline_results.json"), fid_input_size=fid_input_size,
            **(config or {}))
    finally:
        os.chdir(cwd)
    files = sorted(os.path.relpath(os.path.join(d, f), workdir)
                   for d, _, names in os.walk(workdir) for f in names)
    return {"record": record, "files": files}


SCENARIOS = {"steps": scenario_steps, "generate": scenario_generate, "fid": scenario_fid,
             "fit": scenario_fit, "measure_baseline": scenario_measure_baseline}


# -------------------------------------------------------------------- a rank


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="one rank of parallel.launch.launch")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world-size", type=int, required=True)
    p.add_argument("--dir", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None)
    p.add_argument("--timeout", type=float, default=600.0)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .distributed import shutdown
    from .mesh import make_group

    torch.set_num_threads(RANK_THREADS)
    job = torch.load(os.path.join(args.dir, "job.pt"), weights_only=True)
    apply_numeric_settings(job["settings"])
    group = make_group(
        args.device, backend=args.backend, world_size=args.world_size, rank=args.rank,
        init_method="file://" + os.path.join(args.dir, "store"),
        timeout=datetime.timedelta(seconds=args.timeout),
    )
    results = []
    try:
        for name, kwargs in job["scenarios"]:
            try:
                result = SCENARIOS[name](group, **kwargs)
            except Exception as e:  # recorded for the caller; the next scenario runs
                traceback.print_exc()
                result = {"error": f"{type(e).__name__}: {e}"}
            result["jax_loaded"] = "jax" in sys.modules
            results.append(result)
    finally:
        shutdown()
    torch.save(results, os.path.join(args.dir, f"rank{args.rank}.pt"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
