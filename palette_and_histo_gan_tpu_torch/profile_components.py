"""Each sub-computation of the histogram variant's train step, timed alone.

    python -m palette_and_histo_gan_tpu_torch.profile_components [--batch 1024]
        [--dtype bfloat16] [--out build/profile_components.json] [--device cuda|cpu]

The counterpart of `scripts/profile_components.py`. Components, with the
script's names, on a full-width histogram configuration and seeded inputs
(`src`, `tgt` uniform in [-1, 1], float32 NHWC; `raw`, uint8 RGBA packed
to a word a pixel as the chunk packs it):

  g_fwd_dropout, g_fwd_no_dropout  the generator's forward (no graph);
  g_fwd_bwd                        its forward and the parameters' gradient;
  d_fwd, d_fwd_bwd                 the discriminator, the same way;
  hist_fwd_bwd                     both histograms of the CLI's default
                                   path (on a card "pallas2": K3b, K4b)
                                   and the Hellinger loss, the gradient
                                   taken with respect to the fake image;
  augment                          kernel K1 on the packed pair;
  adam_updates                     both KerasAdam steps on zero gradients.

The script's alternative `transpose_impl` row is a TPU lowering the port
does not have. Each component is timed two ways: its device time a call
(torch.profiler over CALLS calls of each, in one profile, `device_times`)
and the host marginal clock (`utils/profiling.py::marginal_call_seconds`,
16 against 4 calls, best of 3), with the kernels' launches a call counted
over the profiled calls.
The production step's own device time (`sweep.py`'s program) is printed
beside them for scale only: the components overlap in what they count.
`--device cpu` is a request: the host clock only, the device fields null.
Prints the card's line, then a JSON line a component, and writes `--out`
(under `build/`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np
import torch

from .config import config_for_variant, float32_exact
from .utils import profiling, tracing

CALLS = 10
SEED = 0
COMPONENTS = ("g_fwd_dropout", "g_fwd_no_dropout", "g_fwd_bwd", "d_fwd", "d_fwd_bwd",
              "hist_fwd_bwd", "augment", "adam_updates")


def inputs(batch: int, device, seed: int = SEED) -> dict:
    """src, tgt: float32 NHWC in [-1, 1]; raw: a uint8 pair packed."""
    from .train.steps import pack_rows

    rng = np.random.default_rng(seed)
    src, tgt = (torch.from_numpy(rng.uniform(-1, 1, (batch, 64, 64, 4)).astype(np.float32))
                for _ in range(2))
    raw = [torch.from_numpy(rng.integers(0, 256, (batch, 64, 64, 4)).astype(np.uint8))
           for _ in range(2)]
    return {"src": src.to(device), "tgt": tgt.to(device),
            "raw": [pack_rows(x.to(device)) for x in raw]}


def histogram_loss_fn(config):
    """(fake, real) -> the step's Hellinger loss of their histograms, on the
    config's histogram path (train/steps.py::histogram_fn)."""
    from .config import compute_dtype
    from .ops import histogram as hist_ops
    from .train.steps import histogram_fn

    hist_fn = histogram_fn(config)
    kw = dict(size=config.histogram_size, method=config.histogram_method,
              sigma=config.histogram_sigma, dtype=compute_dtype(config))

    def loss(fake, real):
        return hist_ops.hellinger_loss(hist_fn(real, **kw), hist_fn(fake, **kw))

    return loss


def components(config, state, data: dict) -> dict:
    """name -> a call of no arguments, on `state`'s networks and optimizers."""
    from .config import compute_dtype
    from .ops import augment

    gen, disc = state.generator, state.discriminator
    src, tgt, raw = data["src"], data["tgt"], data["raw"]
    drop = state.dropout_generator
    g_params, d_params = list(gen.parameters()), list(disc.parameters())
    hist_loss = histogram_loss_fn(config)

    @torch.no_grad()
    def g_fwd_dropout():
        return gen(src, drop).sum()

    @torch.no_grad()
    def g_fwd_no_dropout():
        return gen(src, None, deterministic=True).sum()

    def g_fwd_bwd():
        return torch.autograd.grad(gen(src, drop).sum(), g_params)

    @torch.no_grad()
    def d_fwd():
        return disc(tgt, src).sum()

    def d_fwd_bwd():
        return torch.autograd.grad(disc(tgt, src).sum(), d_params)

    def hist_fwd_bwd():
        fake = src.detach().requires_grad_(True)
        return torch.autograd.grad(hist_loss(fake, tgt), fake)[0]

    def augment_call():
        return augment.augment_batch_sharded(
            raw[0], raw[1], state.aug_generator, config.augment_probability,
            global_batch=raw[0].shape[0], normalize_out=True, out_dtype=compute_dtype(config))

    @torch.no_grad()
    def adam_updates():
        for params, optimizer in ((g_params, state.g_optimizer), (d_params, state.d_optimizer)):
            for p in params:
                p.grad = torch.zeros_like(p)
            optimizer.step()
        return g_params[0]

    return {"g_fwd_dropout": g_fwd_dropout, "g_fwd_no_dropout": g_fwd_no_dropout,
            "g_fwd_bwd": g_fwd_bwd, "d_fwd": d_fwd, "d_fwd_bwd": d_fwd_bwd,
            "hist_fwd_bwd": hist_fwd_bwd, "augment": augment_call,
            "adam_updates": adam_updates}


def device_times(calls: dict) -> dict:
    """name -> (device ms a call, launches a call) of each component, from
    one profile: CALLS calls of each in turn, between two synchronizations
    inside a range of its own. A device row belongs to the component whose
    range holds its start (every row of a component runs inside its range:
    the range ends after a synchronization). Raises for a component with
    no device time: the device clock is never replaced by the host's."""
    from .sweep import launches_since, read_launches

    launches = {}
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for name, fn in calls.items():
            before = read_launches()
            with torch.profiler.record_function(f"component:{name}"):
                for _ in range(CALLS):
                    fn()
                torch.cuda.synchronize()
            launches[name] = {k: v / CALLS for k, v in launches_since(before).items()}
    tracing.clear()  # the spans the profile recorded: its rows hold what is read
    raw = list(prof.profiler.kineto_results.events())
    cpu = torch.autograd.DeviceType.CPU
    spans = {k.name()[len("component:"):]: (k.start_ns(), k.end_ns()) for k in raw
             if k.name().startswith("component:") and k.device_type() == cpu}
    busy = dict.fromkeys(calls, 0)
    for k in raw:
        # device work as utils/profiling.py::device_seconds counts it
        if k.device_type() != cpu and not k.is_user_annotation() and not (
                k.name().startswith("Optimizer.")):
            for name, (start, end) in spans.items():
                if start <= k.start_ns() < end:
                    busy[name] += k.duration_ns()
    empty = [name for name, ns in busy.items() if ns <= 0]
    if empty:
        raise RuntimeError(f"profile_components: no device time for {empty}")
    return {name: (ns / 1e6 / CALLS, launches[name]) for name, ns in busy.items()}


def run(batch: int, dtype: str, device, **config_kw) -> dict:
    """Every component timed, and the step's own device time for scale."""
    from .sweep import default_histogram_impl, prepare
    from .train.state import create_train_state

    device = torch.device(device)
    on_card = device.type == "cuda"
    impl = default_histogram_impl(device)
    config = config_for_variant("histogram", compute_dtype=dtype, batch_size=batch,
                                histogram_impl=impl, **config_kw)
    scope = float32_exact if dtype == "float32" else contextlib.nullcontext
    rows = {}
    with scope():
        state = create_train_state(config, device, SEED)
        calls = components(config, state, inputs(batch, device))
        for name in COMPONENTS:
            rows[name] = {"device_ms": None, "launches_per_call": {},
                          "host_marginal_ms": 1e3 * profiling.marginal_call_seconds(calls[name])}
        if on_card:
            for name, (ms, launches) in device_times(calls).items():
                rows[name].update(device_ms=ms, launches_per_call=launches)
        del state, calls
        step = None
        if on_card:
            setup = prepare("histogram", batch, dtype, device, histogram_impl=impl, **config_kw)
            setup.timed(2)  # warm-up
            step = profiling.device_step_seconds(setup.run, CALLS)
    return {"batch": batch, "dtype": dtype, "histogram_impl": impl, "device": str(device),
            "components": rows, "step_device_ms": None if step is None else 1e3 * step}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="phg-profile-components",
                                description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--out", default="build/profile_components.json")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_components: PyTorch sees no CUDA device "
                         "(--device cpu runs on the CPU)")
    card = profiling.card_line() if device.type == "cuda" else f"{device}: no card"
    print(card, flush=True)
    out = run(args.batch, args.dtype, device)
    for name, row in out["components"].items():
        print(json.dumps({"component": name, **row}), flush=True)
    print(json.dumps({"step_device_ms": out["step_device_ms"]}), flush=True)
    path = profiling.write_build_json(args.out, {"card": card, **out})
    print(f"wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
