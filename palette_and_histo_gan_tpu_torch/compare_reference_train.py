"""The port's side of the measured training-quality comparison.

    python -m palette_and_histo_gan_tpu_torch.compare_reference_train \
        [--variant baseline-no-aug] [--steps 1000] [--eval-every 100] \
        [--data-root DIR] [--fid-at 2520,5040,10080 --inception-npz NPZ] \
        [--reference reference_train_tf.json] [--out build/build_train_torch.json] \
        [--device cuda|cpu]

The counterpart of `scripts/compare_reference_train.py`: "does the port
train to the same quality on the same schedule?". It runs the production
step, `train/steps.py::make_train_step`, under the regime of ref_regime.py
(the reference-faithful init through `models/convert.py`'s Flax trees,
dropout off, no augmentation draws, the batch order from seed 47, the
test-L1 protocol), then compares the run with a record of the same regime:
the TF reference's (`reference_train_tf*.json`) or the JAX build's
(`build_train_jax*.json`), per-window mean losses and the test-L1 curve.
A record of another variant or step count is not compared.

The per-step metrics stay on the device and come to the host once per
eval window, as the JAX script fetches them. The record has the JAX
record's keys with their meanings; `framework` names torch and the card,
and the port adds `host_ms_per_step` (the loop's host time a step, the
evaluations left out), `histogram_impl` and `data_root`. The histogram
runs as the CLI runs it: "pallas2" on a card (kernels K3b and K4b in the
regime's float32), the plain "xla" on the CPU. Float32 runs with TF32 off
(`config.py::float32_exact`).

`--fid-at` reports the FID curve (the reference's scipy formula and the
port's low-rank distance) on the features of the shared-init InceptionV3
that `--inception-npz` names, the file scripts/make_shared_inception.py
writes and `python -m palette_and_histo_gan_tpu_torch.convert_inception
--shared-init OUT.npz` draws bit for bit without TensorFlow; without one
that exists it raises: a curve on random weights would not compare with the
TF record's. The indexed regime has no FID curve.

It runs on `cuda` unless `--device cpu` is given, prints the card's line
first and writes its record only under `build/`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from . import ref_regime
from .config import config_for_variant, default_data_root, float32_exact
from .models import convert
from .sweep import default_histogram_impl
from .utils import profiling

DROPOUT = "off (comparability regime, see scripts/ref_regime.py)"
# the step's metrics each regime records, by their curve names
RGBA_CURVES = (("g_total", "generator/total_loss"), ("d_total", "discriminator/total_loss"),
               ("g_adv", "generator/adversarial_loss"), ("g_l1", "generator/l1_loss"))
INDEXED_CURVES = RGBA_CURVES[:3] + (("segmentation", "generator/segmentation_loss"),)


def regime_config(variant: str, device, root: str | None = None,
                  histogram_impl: str | None = None):
    """The variant's configuration under the regime: dropout off and, for
    the RGBA variants, the augmentation a pass-through; `histogram_impl`,
    by default the one the CLI picks on `device`."""
    kw = dict(deterministic_dropout=True, donate_state=False,
              data_root=default_data_root() if root is None else root,
              histogram_impl=histogram_impl or default_histogram_impl(torch.device(device)))
    if variant != "indexed":
        kw["augment_probability"] = 0.0
    return config_for_variant(variant, **kw)


def initial_state(config, device):
    """A train state on `device` holding the reference-faithful init
    (ref_regime.reference_init of the weight specs), carried in as the
    JAX package's Flax trees; the state's own generators draw nothing
    under the regime."""
    from .train.state import create_train_state

    state = create_train_state(config, device, seed=0)
    g_named = ref_regime.reference_init(convert.generator_weight_spec(
        config.generator_in_channels, config.generator_out_channels))
    d_named = ref_regime.reference_init(
        convert.discriminator_weight_spec(config.discriminator_in_channels))
    convert.load_flax_params(state.generator, state.discriminator,
                             convert.generator_tree_from_named(g_named),
                             convert.discriminator_tree_from_named(d_named))
    return state


def framework(device: torch.device) -> str:
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return f"torch-{torch.__version__} ({where}, production step path)"


def _regime_data(config, state, device, root):
    """(train sources, train targets) on `device`, and the test-L1 function
    of the regime: mean |target - G(source)| on the [-1, 1] scale for the
    RGBA variants; for indexed, the argmax of the logits and the target
    decoded through the pair's palette, on the [0, 255] scale. Returns
    also the normalized test sources and targets (RGBA) for FID."""
    gen = state.generator
    if config.is_indexed:
        (tr_src, tr_tgt, _), (te_src, te_tgt, te_pal) = ref_regime.load_indexed_splits(
            root, device)
        test_src = torch.from_numpy(te_src.astype(np.float32)).to(device)
        decoded_real = ref_regime.decode_indexed(te_tgt, te_pal)

        @torch.no_grad()
        def eval_l1() -> float:
            logits = gen(test_src, None, deterministic=True, logits=True)
            fake = torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32).cpu().numpy()
            return float(np.abs(decoded_real - ref_regime.decode_indexed(fake, te_pal)).mean())

        test = None
    else:
        tr_src, tr_tgt, te_src, te_tgt = ref_regime.load_splits(root)
        test = tuple(torch.from_numpy(ref_regime.normalize(a)).to(device)
                     for a in (te_src, te_tgt))

        @torch.no_grad()
        def eval_l1() -> float:
            return float(torch.mean(torch.abs(test[1] - gen(test[0], None, deterministic=True))))

    train = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (tr_src, tr_tgt))
    return train, eval_l1, test


def train(variant: str, steps: int, eval_every: int, fid_at=(), root: str | None = None,
          device="cuda", inception_npz: str | None = None,
          histogram_impl: str | None = None) -> dict:
    """`steps` regime steps of `variant` from the dataset root `root`
    (default: default_data_root()) on `device`, the test L1 after the first
    step and every `eval_every`; the FID at each step of `fid_at` (RGBA
    variants) on the features of the InceptionV3 at `inception_npz`.
    `histogram_impl` defaults to the CLI's choice on `device`. Returns the
    record."""
    from .eval import fid
    from .train.steps import make_train_step

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for, but PyTorch sees no CUDA device")
    fid_at = sorted(fid_at)
    if fid_at and variant == "indexed":
        raise ValueError("the indexed regime has no FID curve (its test metric is the "
                         "palette-decoded L1)")
    if fid_at and not (inception_npz and os.path.isfile(inception_npz)):
        raise FileNotFoundError(
            f"--fid-at needs --inception-npz to name the shared-init InceptionV3 weights "
            f"(scripts/make_shared_inception.py writes them); got {inception_npz!r}. A curve "
            "on random weights would not compare with the reference's")
    root = default_data_root() if root is None else root
    config = regime_config(variant, device, root, histogram_impl)
    names = INDEXED_CURVES if config.is_indexed else RGBA_CURVES
    with float32_exact():
        state = initial_state(config, device)
        step_fn = make_train_step(config)
        (sources, targets), eval_l1, test = _regime_data(config, state, device, root)
        order = torch.from_numpy(ref_regime.batch_order(sources.shape[0], steps)).to(device)

        fid_eval = real_acts = None
        if fid_at:
            fid_eval = fid.FidEvaluator(batch_size=44, device=device, weights=inception_npz)
            real_acts = fid_eval.activations(test[1])

        curves = {name: [] for name, _ in names}
        pending = []

        def flush():
            if pending:
                rows = torch.stack([torch.stack([m[k] for _, k in names]) for m in pending])
                for row in rows.float().cpu().tolist():
                    for (name, _), v in zip(names, row):
                        curves[name].append(v)
                pending.clear()

        eval_steps, eval_l1s = [], []
        fid_steps, fid_values, fid_lowrank = [], [], []
        eval_seconds = 0.0
        t0 = time.perf_counter()
        for k in range(steps):
            idx = order[k]
            pending.append(step_fn(state, sources[idx], targets[idx]))
            if (k + 1) % eval_every == 0 or k == 0:
                t_eval = time.perf_counter()
                flush()
                eval_steps.append(k + 1)
                eval_l1s.append(eval_l1())
                last = {name: c[-1] for name, c in curves.items()}
                tail = (f"seg {last['segmentation']:7.4f}" if config.is_indexed
                        else f"train_l1 {last['g_l1']:7.4f}")
                print(f"step {k + 1:5d}: G {last['g_total']:8.4f} D {last['d_total']:7.4f} "
                      f"{tail} test_l1 {eval_l1s[-1]:8.4f} ({time.perf_counter() - t0:6.1f}s)",
                      flush=True)
                eval_seconds += time.perf_counter() - t_eval
            if fid_eval is not None and (k + 1) in fid_at:
                t_eval = time.perf_counter()
                with torch.no_grad():
                    fake = state.generator(test[0], None, deterministic=True)
                fake_acts = fid_eval.activations(fake)
                fid_steps.append(k + 1)
                fid_values.append(ref_regime.reference_fid_from_acts(
                    real_acts.cpu().numpy(), fake_acts.cpu().numpy()))
                fid_lowrank.append(float(fid.frechet_distance_lowrank(real_acts, fake_acts)))
                print(f"step {k + 1:5d}: FID {fid_values[-1]:10.6g} (scipy) "
                      f"{fid_lowrank[-1]:10.6g} (lowrank, production)", flush=True)
                eval_seconds += time.perf_counter() - t_eval
        flush()
        wall = time.perf_counter() - t0

    record = {
        "framework": framework(device),
        "variant": variant,
        "steps": steps,
        "batch": ref_regime.BATCH,
        "dropout": DROPOUT,
        "wall_seconds": wall,
        "curves": curves,
        "g_total_window_means": ref_regime.window_means(curves["g_total"]),
        "d_total_window_means": ref_regime.window_means(curves["d_total"]),
    }
    if config.is_indexed:
        record["segmentation_window_means"] = ref_regime.window_means(curves["segmentation"])
    else:
        record["g_l1_window_means"] = ref_regime.window_means(curves["g_l1"])
    record.update(eval_steps=eval_steps, eval_l1=eval_l1s)
    if not config.is_indexed:
        record.update(fid_steps=fid_steps, fid=fid_values, fid_lowrank=fid_lowrank,
                      fid_features=(f"shared-init InceptionV3 ({os.path.basename(inception_npz)})"
                                    if fid_steps else None))
    record.update(host_ms_per_step=1e3 * (wall - eval_seconds) / steps,
                  histogram_impl=config.histogram_impl, data_root=root)
    return record


def compare(build: dict, ref: dict) -> None:
    """The JAX script's table: per-window means, the test-L1 curve and, where
    both records hold one, the FID curve, each with its relative gap."""
    print(f"\n=== port ({build['framework']}) vs reference ({ref['framework']}) ===")
    for key, label in (
        ("g_total_window_means", "G loss"),
        ("d_total_window_means", "D loss"),
        ("g_l1_window_means", "train L1"),
        ("segmentation_window_means", "seg CE"),
    ):
        if key not in build or key not in ref:
            continue
        print(f"{label:9s} windows:")
        for i, (bv, rv) in enumerate(zip(build[key], ref[key])):
            rel = abs(bv - rv) / max(abs(rv), 1e-9)
            print(f"  w{i}: build {bv:9.4f}  ref {rv:9.4f}  rel {rel:6.1%}")
    print("test L1 curve:")
    for s, bv, rv in zip(build["eval_steps"], build["eval_l1"], ref["eval_l1"]):
        rel = abs(bv - rv) / max(abs(rv), 1e-9)
        print(f"  step {s:5d}: build {bv:7.4f}  ref {rv:7.4f}  rel {rel:6.1%}")
    if build.get("fid") and ref.get("fid"):
        print("FID curve (shared-init InceptionV3 features):")
        for s, bv, rv in zip(build["fid_steps"], build["fid"], ref["fid"]):
            rel = abs(bv - rv) / max(abs(rv), 1e-9)
            print(f"  step {s:5d}: build {bv:10.6g}  ref {rv:10.6g}  rel {rel:6.1%}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="phg-compare-reference-train",
                                description=__doc__.split("\n")[0])
    p.add_argument("--variant", default="baseline-no-aug",
                   choices=("baseline-no-aug", "baseline", "histogram", "indexed"))
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--eval-every", type=int, default=100)
    p.add_argument("--fid-at", default="", help="comma list of FID steps")
    p.add_argument("--inception-npz", default=None,
                   help="the shared-init InceptionV3 weights --fid-at needs")
    p.add_argument("--data-root", default=None, help="default: $PHG_DATA_ROOT or "
                   "datasets/rpg-maker-xp")
    p.add_argument("--reference", default="reference_train_tf.json")
    p.add_argument("--out", default="build/build_train_torch.json")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("compare_reference_train: PyTorch sees no CUDA device "
                         "(--device cpu runs on the CPU)")
    print(profiling.card_line() if device.type == "cuda" else f"{device}: no card", flush=True)
    result = train(args.variant, args.steps, args.eval_every,
                   ref_regime.parse_fid_at(args.fid_at), args.data_root, device,
                   args.inception_npz)
    path = profiling.write_build_json(args.out, result)
    print(f"wrote {path}: final test L1 {result['eval_l1'][-1]:.4f}", flush=True)
    if os.path.exists(args.reference):
        with open(args.reference) as f:
            ref = json.load(f)
        if ref["variant"] == result["variant"] and ref["steps"] == result["steps"]:
            compare(result, ref)
        else:
            print("reference JSON is for a different regime; not comparing", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
