"""Entry "histogan_chunk": train/histogan.py::make_histogan_chunk of the
program on one device, `steps_per_chunk` steps a call (16: one whole lazy
period, one R1 and four path-length phases), the stacked metrics fetched
to the host once a chunk; the window as entries/chunk.py's.

Set-up builds the state (the benchmark's parameters, buffers and seeds
loaded) and the chunk; the first steps and the window go through
`run_chunk`, the same call on the same state and images, under the
port's float32_exact (TF32 off).
"""

from __future__ import annotations

from . import chunk as _chunk


def setup(ctx) -> None:
    from palette_and_histo_gan_tpu_torch.config import float32_exact
    from palette_and_histo_gan_tpu_torch.train.histogan import (create_histogan_state,
                                                                make_histogan_chunk)

    model = ctx.cell.model
    config = model.port_config(ctx.cell, ctx.seeds)
    ctx.config = config
    ctx.state = create_histogan_state(config, ctx.device, ctx.seeds["weights"])
    model.load_state(ctx.state, ctx.weights, ctx.seeds)
    ctx.dataset = ctx.data["train"][0]
    chunk = make_histogan_chunk(config, ctx.dataset.shape[0], ctx.seeds["sampler"])

    def run_chunk(n: int) -> dict:
        with float32_exact():
            return chunk(ctx.state, ctx.dataset, n)

    ctx.run_chunk = run_chunk


warm, window, free = _chunk.warm, _chunk.window, _chunk.free
