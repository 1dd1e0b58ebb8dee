"""Entry "chunk": train/steps.py::make_train_chunk of the program on one
device, `steps_per_chunk` steps a call, the stacked metrics fetched to the
host once a chunk, as the Trainer fetches them.

Set-up builds the state (the benchmark's weights and seeds loaded) and the
chunk; the first steps and the window go through `run_chunk`, the same
call on the same state and data. The window runs chunks until `seconds`
have passed; it ends at the fetch of the last chunk's metrics.
"""

from __future__ import annotations

import contextlib
import time

import torch


def _make_chunk(ctx, config):
    from palette_and_histo_gan_tpu_torch.train.steps import make_train_chunk

    return make_train_chunk(config, ctx.dataset[0].shape[0], ctx.seeds["sampler"])


def setup(ctx, make_chunk=_make_chunk) -> None:
    from palette_and_histo_gan_tpu_torch.config import check_supported, float32_exact
    from palette_and_histo_gan_tpu_torch.train.state import create_train_state

    model = ctx.cell.model
    config = model.port_config(ctx.cell, ctx.seeds)
    check_supported(config, ctx.device)
    ctx.config = config
    ctx.state = create_train_state(config, ctx.device, ctx.seeds["weights"])
    model.load_state(ctx.state, ctx.weights, ctx.seeds)
    ctx.dataset = ctx.data["train"]
    chunk = make_chunk(ctx, config)
    exact = float32_exact if config.compute_dtype == "float32" else contextlib.nullcontext

    def run_chunk(n: int) -> dict:
        with exact():
            return chunk(ctx.state, ctx.dataset, n)

    ctx.run_chunk = run_chunk


def warm(ctx) -> None:
    """Nothing beyond the first steps: they ran every shape of the window."""


def _fetch(model, metrics: dict) -> list[float]:
    """The chunk's one device-to-host copy; its losses, a step's generator
    and discriminator loss after another."""
    names = list(metrics)
    host = torch.stack([metrics[k] for k in names]).float().cpu()
    return [v for pair in model.losses_of(dict(zip(names, host))) for v in pair]


def window(ctx, seconds: float, tracer) -> dict:
    per_chunk = ctx.cell.traffic["steps_per_chunk"]
    model = ctx.cell.model
    losses, steps, i = [], 0, 0
    t0 = time.perf_counter()
    while True:
        tracer.at_chunk(i)
        losses += _fetch(model, ctx.run_chunk(per_chunk))
        steps += per_chunk
        i += 1
        if ctx.agree(time.perf_counter() - t0 >= seconds):
            break
    elapsed = time.perf_counter() - t0
    tracer.finish()
    return {"steps": steps, "seconds": elapsed, "losses": losses}


def free(ctx) -> None:
    ctx.state = ctx.run_chunk = ctx.dataset = None
