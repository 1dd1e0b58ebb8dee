"""Entry "dp_chunk": parallel/dp.py::make_dp_train_chunk of the program,
one rank a card over NCCL, the global batch split over the ranks; the
state replicated from rank 0 as the Trainer replicates it. Otherwise as
entries/chunk.py: each rank runs the chunks, rank 0 decides when the
window ends and the others follow."""

from __future__ import annotations

from . import chunk


def _make_dp_chunk(ctx, config):
    from palette_and_histo_gan_tpu_torch.parallel.dp import make_dp_train_chunk
    from palette_and_histo_gan_tpu_torch.parallel.mesh import replicate_state

    replicate_state(ctx.group, ctx.state)
    return make_dp_train_chunk(config, ctx.group, ctx.dataset[0].shape[0], ctx.seeds["sampler"])


def setup(ctx) -> None:
    if ctx.group is None:
        raise SystemExit("entry dp_chunk needs a data-parallel group of the cell's chips")
    chunk.setup(ctx, _make_dp_chunk)


warm = chunk.warm
window = chunk.window
free = chunk.free
