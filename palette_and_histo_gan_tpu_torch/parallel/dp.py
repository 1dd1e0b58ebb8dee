"""Data-parallel train step, train chunk and generate.

Counterpart of palette_and_histo_gan_tpu/parallel/dp.py. One process a
rank, the parameters and optimizer state the same on every rank
(mesh.replicate_state), the global batch (`config.batch_size`) split over
the ranks in contiguous rows. The step is the one-process step with the
group passed down (train/steps.py), as the JAX steps take `mesh=`:

  * the augmentation's draws and the dropout masks are drawn for the
    whole batch on every rank, which keeps its rows;
  * after both backward passes each network's gradients are averaged over
    the ranks, one flat all_reduce a network, two a step. There is no DDP
    wrapper: the step's three discriminator passes and its
    backward(inputs=...) split do not fit DDP's one-forward-one-backward
    hooks;
  * the L1, BCE and cross-entropy terms are means over the batch, so the
    mean of the ranks' gradients is the global batch's. The Hellinger loss
    is not: it is one norm over the whole batch's histograms, divided by
    B, so its sum of squares is summed over the ranks first
    (ops/histogram.py::hellinger_loss). A rank's own Hellinger over its
    B/N rows would read about sqrt(N) times the loss, and its gradient
    would be as far off (the JAX docstring's "every loss is a mean" holds
    there only because GSPMD compiles one global program);
  * the chunk's metrics are averaged over the ranks once a chunk.

N ranks compute what one process computes: the same losses and, up to
the order of the sums, the same parameters (tests/test_torch_parallel.py).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..config import Config
from ..models.networks import DropoutDraw
from ..train.steps import generate, make_train_chunk, make_train_step
from .mesh import DataGroup


def make_dp_train_step(config: Config, group: DataGroup) -> Callable:
    """train/steps.py::make_train_step over the group, the one way to a
    data-parallel step: (state, source, target) -> metrics, updating
    `state` in place; `source` and `target` are this rank's rows of the
    global batch (mesh.shard_batch), the metrics the global batch's (one
    all_reduce)."""
    return make_train_step(config, group)


def make_dp_train_chunk(config: Config, group: DataGroup, dataset_size: int,
                        data_seed: int) -> Callable:
    """train/steps.py::make_train_chunk over the group, the one way to a
    data-parallel chunk (the Trainer's): (state, (sources, targets),
    num_steps) -> metrics stacked over the steps. Every rank holds the
    whole splits, draws the same global batch indices and gathers only its
    rows; the stacked metrics are averaged over the ranks in one
    all_reduce."""
    return make_train_chunk(config, dataset_size, data_seed, group)


def make_dp_generate_fn(group: DataGroup) -> Callable:
    """train/steps.py::generate with the batch split over the ranks, a
    drop-in for it: (config, generator, source, dropout_generator) -> the
    whole batch's output on every rank. Evaluation batches (44 images,
    6-image previews, single patch-map pairs) rarely divide the world size,
    so the n sources are padded to a multiple of it with copies of the
    first and the output sliced back to n. The dropout masks are drawn for
    the n rows, as one process draws them, and each rank keeps its rows
    (padding rows keep every unit), so the output equals one process's
    generate for every n."""

    def generate_padded(config: Config, generator, source: torch.Tensor,
                        dropout_generator: torch.Generator) -> torch.Tensor:
        n = source.shape[0]
        per = -(-n // group.world_size)
        pad = per * group.world_size - n
        if pad:
            source = torch.cat([source, source[:1].expand(pad, *source.shape[1:])])
        first = group.rank * per
        local = generate(config, generator, source[first:first + per],
                         DropoutDraw(dropout_generator, n, first))
        return group.gather_rows(local, n)

    return generate_padded
