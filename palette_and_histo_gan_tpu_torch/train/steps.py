"""The train steps of the four variants, the chunked training loop and the
generate core.

Mirrors palette_and_histo_gan_tpu/train/steps.py: `rgba_train_step`
(:170-310) with its histogram dispatch (:234-276), `indexed_train_step`
(:318-394), the u32 row pack (:402-426), `make_train_step` (:454),
`make_train_chunk` (:467-515), `generate_core` (:536-570) and
`make_discriminate_fn` (:578-588). Where JAX
takes `value_and_grad` of two pure loss functions, a step runs the
generator once, backpropagates the generator loss into the generator's
parameters only, runs the discriminator on the detached fake,
backpropagates into the discriminator's parameters only, and then applies
both Adam updates, so both gradients see the parameters of before the
step. Metric names are the JAX package's `generator/*` and
`discriminator/*`.

Data parallelism passes a `group` (parallel/mesh.py::DataGroup) down, as
the JAX steps take `mesh=`: the step then runs on this rank's rows of the
global batch, draws the augmentation and the dropout masks for the whole
batch and keeps its rows, sums the Hellinger loss over the ranks, and
averages each network's gradients over the ranks (one flat all_reduce a
network) before the two Adam updates; the chunk gathers this rank's rows
of the global batch and averages the stacked metrics over the ranks once
a chunk.

Spans (utils/tracing.py) mark each step and the step's parts, the
forward ones with the JAX roofline's group names: "batch-gather" (the
chunk's draw and gather, and the batch's unpack and normalize where there
is no augmentation), "augment", "G-fwd", "D-fwd", "hist-fwd", "loss",
"optimizer"; and "G-bwd" (with the mark "G-out" where the gradient of G's
output is ready), "D-bwd", "allreduce". Each part is also a
`torch.profiler.record_function` range while a profiler records; the step
is not. They change no operation of the step. roofline.py attributes the
device time of each kernel to its forward range, and a backward kernel to
the range of the forward operation whose autograd node ran it.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from ..config import Config, compute_dtype
from ..data.loader import batch_indices
from ..ops import augment as augment_ops
from ..ops import histogram as hist_ops
from ..ops.histogram_pallas import calculate_rgbuv_histogram_pallas
from ..ops.histogram_pallas2 import calculate_rgbuv_histogram_pallas2
from ..ops.indexed_loss import indexed_losses
from ..models.networks import DropoutDraw
from ..ops.image import normalize
from ..utils import tracing
from .losses import bce_with_logits, discriminator_loss, generator_loss
from .state import TrainState


def pack_rows(arr: torch.Tensor) -> torch.Tensor:
    """uint8 (N, 64, 64, 4) -> int32 (N, 4096), each element the bit
    pattern of one little-endian RGBA pixel (a view, no copy). The row
    gather then moves one 4-byte word a pixel, and the augmentation kernel
    unpacks the channels in registers."""
    n = arr.shape[0]
    return arr.contiguous().view(n, -1).view(torch.int32)


def unpack_rows(arr: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_rows on a gathered batch: (B, 64, 64, 4) uint8."""
    return arr.contiguous().view(torch.uint8).reshape(arr.shape[0], 64, 64, 4)


def step_wants_packed(config: Config) -> bool:
    """True when the step consumes packed pixels: the augmentation (kernel
    on the card, plain version on the CPU) unpacks them itself."""
    return config.uses_augmentation


def _global_rows(group, local_b: int) -> tuple[int, int]:
    """(global batch, this rank's first row) of a rank holding local_b rows."""
    if group is None:
        return local_b, 0
    return local_b * group.world_size, local_b * group.rank


def _dropout(config: Config, state: TrainState, group, local_b: int):
    """The dropout masks' source: the state's generator, drawing the whole
    batch's masks under data parallelism."""
    if group is None:
        return state.dropout_generator
    rows, first = _global_rows(group, local_b)
    return DropoutDraw(state.dropout_generator, rows, first)


def _prepare_batch(config: Config, state: TrainState, source, target, group=None):
    """Raw [0, 255] batch -> normalized (augmented) [-1, 1] pair."""
    if config.uses_augmentation:
        # normalize folded into the augmentation's write; in bfloat16 mode
        # it writes bfloat16, as every consumer casts to it anyway
        rows, first = _global_rows(group, source.shape[0])
        with tracing.span("augment"):
            return augment_ops.augment_batch_sharded(
                source, target, state.aug_generator, config.augment_probability,
                global_batch=rows, first_row=first,
                normalize_out=True, out_dtype=compute_dtype(config),
            )
    with tracing.span("batch-gather"):
        if source.dtype == torch.int32:
            source, target = unpack_rows(source), unpack_rows(target)
        return normalize(source.float()), normalize(target.float())


def histogram_fn(config: Config) -> Callable:
    """The histogram of `config.histogram_impl`, called as
    fn(batch, size=, method=, sigma=, dtype=), as the JAX step selects it
    (palette_and_histo_gan_tpu/train/steps.py:234-276): "pallas" drops
    `dtype` (its chain is float32), and `histogram_bwd` counts only under
    "xla"."""
    if config.histogram_impl == "pallas":

        def hist_fn(batch, dtype, **kw):
            return calculate_rgbuv_histogram_pallas(batch, **kw)

        return hist_fn
    if config.histogram_impl == "pallas2":
        return calculate_rgbuv_histogram_pallas2
    return partial(hist_ops.calculate_rgbuv_histogram, bwd=config.histogram_bwd)


def _average_gradients(group, *modules) -> None:
    """Each module's gradients averaged over the ranks, one flat all_reduce
    a module, in the span "allreduce" whose attribute "bytes" is what they
    exchanged (parallel/mesh.py::collectives)."""
    if group is None:
        return
    from ..parallel.mesh import collectives  # parallel imports this module

    counted = collectives["all_reduce"]
    with tracing.span("allreduce") as record:
        before = counted["bytes"]
        for module in modules:
            group.all_reduce_mean_([p.grad for p in module.parameters() if p.grad is not None])
        if record is not None:
            record.attrs["bytes"] = counted["bytes"] - before


def rgba_train_step(config: Config, state: TrainState, source, target, group=None) -> dict:
    """One optimization step on a raw [0, 255] RGBA batch (uint8, float32
    or packed int32), in place on `state`; with `group`, on this rank's
    rows of the global batch. Returns detached 0-dim metrics (this rank's
    under data parallelism)."""
    dropout = _dropout(config, state, group, source.shape[0])
    source, target = _prepare_batch(config, state, source, target, group)
    gen, disc = state.generator, state.discriminator
    dtype = compute_dtype(config)

    with tracing.span("G-fwd"):
        fake = gen(source, dropout, deterministic=config.deterministic_dropout)
    with tracing.span("D-fwd"):
        fake_pred = disc(fake, source)
    with tracing.span("loss"):
        g_metrics = generator_loss(fake_pred, fake, target, config.effective_lambda_l1)
    if config.model == "histogram":
        # two separate histogram calls, real and fake, as the JAX step runs them
        kw = dict(
            size=config.histogram_size, method=config.histogram_method,
            sigma=config.histogram_sigma, dtype=dtype,
        )
        hist_fn = histogram_fn(config)
        with tracing.span("hist-fwd"):
            real_hist = hist_fn(target, **kw)
        with tracing.span("hist-fwd"):
            fake_hist = hist_fn(fake, **kw)
        with tracing.span("loss"):
            h_loss = hist_ops.hellinger_loss(real_hist, fake_hist, group)
            g_metrics["histogram_loss"] = h_loss
            g_metrics["total_loss"] = g_metrics["total_loss"] + config.lambda_histogram * h_loss

    gen.zero_grad(set_to_none=True)
    disc.zero_grad(set_to_none=True)
    with tracing.span("G-bwd") as record:
        tracing.mark_grad(record, fake, "G-out")
        g_metrics["total_loss"].backward(inputs=list(gen.parameters()))

    fake = fake.detach()
    # two separate D passes, as the reference runs them (pix2pix_model.py:69-70)
    with tracing.span("D-fwd"):
        real_pred = disc(target, source)
    with tracing.span("D-fwd"):
        fake_pred = disc(fake, source)
    with tracing.span("loss"):
        d_metrics = discriminator_loss(real_pred, fake_pred)
    with tracing.span("D-bwd"):
        d_metrics["total_loss"].backward(inputs=list(disc.parameters()))

    _average_gradients(group, gen, disc)
    with tracing.span("optimizer"):
        state.g_optimizer.step()
        state.d_optimizer.step()
    state.step += 1
    metrics = {f"generator/{k}": v.detach() for k, v in g_metrics.items()}
    metrics.update({f"discriminator/{k}": v.detach() for k, v in d_metrics.items()})
    return metrics


def indexed_train_step(config: Config, state: TrainState, source_idx, target_idx,
                       group=None) -> dict:
    """One optimization step on int32 (B, 64, 64, 1) palette-index maps, in
    place on `state`. Returns detached 0-dim metrics.

    G sees the source map as float32 on the raw index scale and returns
    256 logits a pixel; the fake map is their argmax. The adversarial term
    goes through that argmax, so it trains nothing: D is evaluated on the
    fake map without a graph and only lambda_segmentation times the sparse
    cross-entropy reaches G (lambda_l1 is 0; the L1 is logged). D's step
    is one pass over the stacked [real; fake] and [source; source] batch,
    as the JAX step runs it (:377-383)."""
    gen, disc = state.generator, state.discriminator
    with tracing.span("batch-gather"):
        source = source_idx.float()
        real = target_idx.float()
        labels = target_idx[..., 0]

    with tracing.span("G-fwd"):
        logits = gen(
            source, _dropout(config, state, group, source.shape[0]),
            deterministic=config.deterministic_dropout, logits=True,
        )
        fake = torch.argmax(logits, dim=-1, keepdim=True).float()
    with torch.no_grad(), tracing.span("D-fwd"):
        fake_pred = disc(fake, source)
    with tracing.span("loss"):
        adversarial = bce_with_logits(torch.ones_like(fake_pred), fake_pred)
        seg, l1 = indexed_losses(labels, logits)
        total = adversarial + config.effective_lambda_l1 * l1 + config.lambda_segmentation * seg
    g_metrics = {
        "total_loss": total,
        "adversarial_loss": adversarial,
        "l1_loss": l1,
        "segmentation_loss": seg,
    }

    gen.zero_grad(set_to_none=True)
    disc.zero_grad(set_to_none=True)
    with tracing.span("G-bwd") as record:
        # the part before the mark is the losses' backward over the logits
        tracing.mark_grad(record, logits, "G-out")
        total.backward(inputs=list(gen.parameters()))
    del logits  # (B, 64, 64, 256): 2 GiB at b1024 bf16 that D's step does not need

    with tracing.span("D-fwd"):
        real_pred, fake_pred = disc(
            torch.cat([real, fake], dim=0), torch.cat([source, source], dim=0)
        ).chunk(2, dim=0)
    with tracing.span("loss"):
        d_metrics = discriminator_loss(real_pred, fake_pred)
    with tracing.span("D-bwd"):
        d_metrics["total_loss"].backward(inputs=list(disc.parameters()))

    _average_gradients(group, gen, disc)
    with tracing.span("optimizer"):
        state.g_optimizer.step()
        state.d_optimizer.step()
    state.step += 1
    metrics = {f"generator/{k}": v.detach() for k, v in g_metrics.items()}
    metrics.update({f"discriminator/{k}": v.detach() for k, v in d_metrics.items()})
    return metrics


def step_function(config: Config) -> Callable:
    """The variant's step, (config, state, source, target) -> metrics."""
    return indexed_train_step if config.is_indexed else rgba_train_step


def _mean_over_ranks(metrics: list[dict], group) -> dict:
    """The metrics of the steps stacked, (steps,) each, and under data
    parallelism averaged over the ranks in one all_reduce."""
    names = list(metrics[0])
    stacked = torch.stack([torch.stack([m[k] for m in metrics]) for k in names])
    if group is not None:
        group.all_reduce_mean_([stacked])
    return dict(zip(names, stacked))


def make_train_step(config: Config, group=None) -> Callable:
    """(state, source, target) -> metrics, updating `state` in place.
    `group` is parallel/dp.py::make_dp_train_step's, which is how data
    parallelism reaches this step."""
    step_fn = step_function(config)

    def train_step(state: TrainState, source, target) -> dict:
        metrics = step_fn(config, state, source, target, group)
        if group is None:
            return metrics
        return {k: v[0] for k, v in _mean_over_ranks([metrics], group).items()}

    return train_step


def make_train_chunk(config: Config, dataset_size: int, data_seed: int,
                     group=None) -> Callable:
    """(state, (sources, targets), num_steps) -> metrics stacked over the
    steps, still on the device.

    Each step draws its batch from the epoch-permutation sampler
    (data.loader.batch_indices) at the state's global step and gathers it
    from the device-resident splits: uint8 RGBA, packed to one word a pixel
    when the step takes packed pixels, or the indexed variant's int32 maps
    as they are. The caller fetches the stacked metrics once per chunk.
    `group` is parallel/dp.py::make_dp_train_chunk's, which is how data
    parallelism reaches this chunk."""
    packed = step_wants_packed(config)
    step_fn = step_function(config)
    rows = slice(None) if group is None else group.batch_slice(config.batch_size)

    def train_chunk(state: TrainState, dataset, num_steps: int) -> dict:
        sources, targets = dataset
        if packed:
            sources, targets = pack_rows(sources), pack_rows(targets)
        history = []
        for _ in range(num_steps):
            with tracing.span("step", ranged=False):
                with tracing.span("batch-gather"):
                    idx = batch_indices(
                        data_seed, state.step, dataset_size, config.batch_size, sources.device
                    )[rows]
                    source, target = sources[idx], targets[idx]
                history.append(step_fn(config, state, source, target, group))
        with tracing.span("loss"):
            return _mean_over_ranks(history, group)

    return train_chunk


@torch.no_grad()
def generate(config: Config, generator, source: torch.Tensor,
             dropout_generator: torch.Generator | DropoutDraw) -> torch.Tensor:
    """The generator at inference, dropout active as the reference runs it:
    a normalized RGBA source -> the [-1, 1] fake; an int32 index map ->
    the int32 argmax map of the logits, taken in the compute dtype."""
    if config.is_indexed:
        logits = generator(source.float(), dropout_generator, logits=True)
        return torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)
    return generator(source, dropout_generator)


@torch.no_grad()
def discriminate(config: Config, discriminator, target: torch.Tensor,
                 source: torch.Tensor) -> torch.Tensor:
    """The discriminator's patch probabilities, the sigmoid of its
    (B, 32, 32, 1) logits, for the patch-map debug figures."""
    return torch.sigmoid(discriminator(target, source))
