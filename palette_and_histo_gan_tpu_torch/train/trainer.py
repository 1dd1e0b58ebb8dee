"""Training loop with its lifecycle: chunked steps, per-step scalars, ETA,
previews, discriminator patch maps, L1 and FID evaluation, checkpoints and
resume, weight files, weight import and image dumps.

Mirrors palette_and_histo_gan_tpu/train/trainer.py (`Trainer`): training
runs in chunks of `update_steps` steps whose metrics stay on the device and
come to the host once per chunk. At the starting step and after every
chunk the host previews 3 test + 3 train translations, draws the
discriminator's patch maps ("show_discriminator_output") and reports the
train/test L1 ("evaluate_l1") and FID ("evaluate_fid"; eval/fid.py, built
at its first report); after every chunk it writes the per-step
scalars at the reference's quantized step (utils/logging.py), prints the
ETA, and every `update_steps * 5` steps and at the end it checkpoints
through train/checkpoint.py::AsyncSaver, whose copies and writes ride
behind the next chunks. `phase_seconds` accumulates wall time per phase.

Previews, patch maps and image dumps run the generator with dropout on,
as the reference does, from generators of their own: one per call seeded
from (seed, PREVIEW_STREAM, step) for previews and dumps (JAX:
fold_in(PRNGKey(seed), step)) and one seeded seed + 1 for each patch map
(JAX: PRNGKey(seed + 1)). They never draw from the state's generators, so
a resumed run, which previews at its starting step, equals the
uninterrupted one. The evaluations seed theirs as the JAX Trainer does: L1
seed + 2, FID seed + 3.

Data parallelism (`config.data_parallel`, JAX: the Trainer's mesh): under
"auto" when a process group of more than one rank exists or torchrun's
WORLD_SIZE is above 1, under "on" always (a world of one included),
never under "off". `config.batch_size` is then the global batch, split
over the ranks (parallel/dp.py); every rank holds the whole datasets,
runs the chunks, the previews and the L1 and FID reports, which hold
collectives, and only rank 0 writes: TensorBoard events, PNGs, weight
files, checkpoints and the console. Restores and weight loads read the
file on every rank and end with rank 0's state on all of them.

Float32 is the reference's float32 (config.py): under a float32 config the
Trainer runs its work (the chunks, the data-parallel chunk included, fit
with its previews, patch maps and reports, the L1 and FID reports, the
image dumps) under config.py::float32_exact, so cuDNN and cuBLAS take no
TF32 whatever the caller set, and the caller's settings come back after
each call. A bfloat16 config runs as the caller set: TF32 touches only
float32 products.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Sequence

import numpy as np
import torch

from ..config import Config, check_supported, float32_exact
from ..data.loader import IndexedDataset, RgbaDataset, make_indexed_datasets, make_rgba_datasets
from ..eval import metrics as eval_metrics
from ..eval.fid import FidEvaluator
from ..models import convert
from ..ops.image import normalize
from ..ops.palette import indexed_to_rgba
from ..parallel import distributed
from ..parallel.dp import make_dp_generate_fn, make_dp_train_chunk
from ..parallel.mesh import DataGroup, make_group, replicate_state
from ..utils import logging as log_utils
from ..utils import visualization as viz
from ..utils.io import delete_folder, ensure_folder_structure, seconds_to_human_readable
from . import checkpoint as ckpt
from .state import TrainState, create_train_state, param_count
from .steps import discriminate, generate, make_train_chunk

SUPPORTED_CALLBACKS = ("evaluate_fid", "evaluate_l1", "show_discriminator_output")
# the previews' stream, past the state's seed + 4 and + 5 (state.py)
PREVIEW_STREAM = 6


def show_eta(training_start_time, step_start_time, current_step, starting_step,
             total_steps, update_steps, say=print):
    """ETA printer (reference side2side_model.py:14-25), through `say`."""
    now = time.time()
    elapsed = now - training_start_time
    steps_so_far = float(current_step - starting_step)
    eta = elapsed / (steps_so_far + 1.0) * (total_steps - steps_so_far)
    say(f"Time since start: {seconds_to_human_readable(elapsed)}")
    say(f"Estimated time to finish: {seconds_to_human_readable(eta)}")
    say(f"Last {update_steps} steps took: {now - step_start_time:.2f}s\n")


def data_group(config: Config, device: torch.device) -> DataGroup | None:
    """The data-parallel group `config.data_parallel` asks for on `device`,
    the process group formed first where needed; None for one device.
    With more than one rank the global batch must split evenly."""
    mode = config.data_parallel
    if mode == "off":
        return None
    if mode == "auto":
        world = (torch.distributed.get_world_size() if torch.distributed.is_initialized()
                 else distributed.torchrun_world_size())
        if world <= 1:
            return None
    group = make_group(device)
    if config.batch_size % group.world_size:
        raise ValueError(
            f"batch_size {config.batch_size} (the global batch) does not split over "
            f"{group.world_size} data-parallel ranks"
        )
    return group


class _NullWriter:
    """The metrics writer of a rank that writes nothing (ranks above 0)."""

    def scalars(self, *args) -> None:
        pass

    def image(self, *args) -> None:
        pass

    def flush(self) -> None:
        pass


class _NullSaver:
    """The checkpoint saver of a rank that writes nothing (ranks above 0)."""

    def save(self, state) -> None:
        pass

    def flush(self) -> None:
        pass


def preview_seed(seed: int, step: int) -> int:
    """The seed of the preview generator at `step`: 64 bits drawn from
    (seed, PREVIEW_STREAM, step), apart from training's seed + 4 / + 5."""
    entropy = np.random.SeedSequence([seed, PREVIEW_STREAM, max(step, 0)])
    return int(entropy.generate_state(1, np.uint64)[0])


def _under_float32_exact(config: Config, fn):
    """`fn`, run under float32_exact when `config` computes in float32."""
    if config.compute_dtype != "float32":
        return fn

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with float32_exact():
            return fn(*args, **kwargs)

    return run


def _float32_work(method):
    """A Trainer method, run under float32_exact when the Trainer's config
    computes in float32."""

    @functools.wraps(method)
    def run(self, *args, **kwargs):
        return _under_float32_exact(self.config, method)(self, *args, **kwargs)

    return run


class Trainer:
    """Training loop of any variant on one explicit device, or on this
    rank's device of a data-parallel group (`data_group`).

    `datasets` is a (train, test) pair already on `device`: RgbaDatasets
    (data.loader.datasets_from_arrays) or, for the indexed variant,
    IndexedDatasets (data.loader.indexed_datasets_from_arrays). By default
    the splits are decoded from config's dataset roots (and, for the
    indexed variant, indexed on the device through kernel K5).
    `fid_evaluator` serves report_fid; by default a FidEvaluator on `device`
    is built at the first report. There is no fallback between devices:
    "cuda" without a card raises.
    """

    def __init__(self, config: Config, device: torch.device | str,
                 datasets: tuple | None = None, fid_evaluator: FidEvaluator | None = None):
        self.device = distributed.rank_device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("device 'cuda' asked for, but PyTorch sees no CUDA device")
            if self.device.index is None:  # tensors report "cuda:N", never "cuda"
                self.device = torch.device("cuda", torch.cuda.current_device())
        check_supported(config, self.device)
        self.group = data_group(config, self.device)
        if self.group is not None and self.group.device != self.device:
            raise ValueError(f"the trainer's device {self.device} is not its rank's "
                             f"{self.group.device}")
        # rank 0 (or the one process) writes events, files and the console:
        # through say, _written, the writer and the saver, which are null
        # objects on the other ranks
        self.writes = self.group is None or self.group.rank == 0
        self.config = config
        if datasets is None:
            make = make_indexed_datasets if config.is_indexed else make_rgba_datasets
            datasets = make(config, self.device)
        self.train_ds, self.test_ds = datasets
        kind = IndexedDataset if config.is_indexed else RgbaDataset
        for ds in datasets:
            if not isinstance(ds, kind):
                raise TypeError(f"the {config.model} variant trains on {kind.__name__}s, "
                                f"got {type(ds).__name__}")
            if ds.sources.device != self.device:
                raise ValueError(f"dataset on {ds.sources.device}, trainer on {self.device}")

        self.state: TrainState = create_train_state(config, self.device, config.seed)
        self.say(f"Generator: unet-gen with {param_count(self.state.generator):,} parameters")
        self.say(
            f"Discriminator: patch-disc with "
            f"{param_count(self.state.discriminator):,} parameters"
        )
        if self.group is None:
            chunk = make_train_chunk(config, self.train_ds.n, config.seed)
            self.generate_fn = generate
        else:
            replicate_state(self.group, self.state)
            chunk = make_dp_train_chunk(config, self.group, self.train_ds.n, config.seed)
            self.generate_fn = make_dp_generate_fn(self.group)
            self.say(
                f"Data parallel over {self.group.world_size} ranks "
                f"({torch.distributed.get_backend()}): batch {config.batch_size} -> "
                f"{config.batch_size // self.group.world_size} a rank"
            )
        # a closure over the chunk, not over self: a Trainer dropped by its
        # caller frees its device memory without waiting for the cyclic GC
        self.train_chunk = _under_float32_exact(config, chunk)
        self.manager = ckpt.make_manager(config)
        self.saver = ckpt.AsyncSaver(self.manager) if self.writes else _NullSaver()
        self.fid = fid_evaluator
        self.writer = None
        self.now_string = None
        self.phase_seconds: dict[str, float] = {}
        # per-step host metrics of every fit, in step order
        self.history: list[dict[str, float]] = []

    @contextlib.contextmanager
    def _phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phase_seconds[name] = (
                self.phase_seconds.get(name, 0.0) + time.perf_counter() - t0
            )

    def say(self, msg: str) -> None:
        """Print on the writing rank."""
        if self.writes:
            print(msg)

    def _written(self, path: str | None) -> str | None:
        """`path` on the writing rank; None, which writes nothing, on the
        others."""
        return path if self.writes else None

    def _replicate(self) -> None:
        """Rank 0's state on every rank (a no-op on one device)."""
        if self.group is not None:
            replicate_state(self.group, self.state)

    def _flush_checkpoints(self) -> None:
        """Land every checkpoint write; under data parallelism no rank
        returns before rank 0's have landed."""
        self.saver.flush()
        if self.group is not None:
            self.group.barrier()

    def _generator(self, seed: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return gen

    # ----------------------------------------------------------------------
    @_float32_work
    def fit(self, steps: int | None = None, update_steps: int | None = None,
            callbacks: Sequence[str] = (), starting_step: int = 0):
        config = self.config
        steps = config.steps if steps is None else steps
        update_steps = config.update_steps if update_steps is None else update_steps
        unsupported = [c for c in callbacks if c not in SUPPORTED_CALLBACKS]
        if unsupported:
            raise ValueError(f"unknown callbacks {unsupported}; supported: {SUPPORTED_CALLBACKS}")
        if starting_step == 0 or self.writer is None:
            self.writer, self.now_string = (log_utils.make_writer(config) if self.writes
                                            else (_NullWriter(), None))
        try:
            self._do_fit(steps, update_steps, callbacks, starting_step)
        finally:
            # a crash mid-chunk keeps the snapshot already taken; a failing
            # flush here must not mask the error that ended the loop (the
            # loop's own flush below raises its failures)
            try:
                self.saver.flush()
            except Exception as e:
                print(f"checkpoint flush on exit failed: {e!r}")
            self.writer.flush()

    def _do_fit(self, steps, update_steps, callbacks, starting_step):
        examples = self.select_examples_for_visualization()
        training_start = step_start = time.time()
        dataset = (self.train_ds.sources, self.train_ds.targets)
        self._update_visualization(examples, starting_step, update_steps, callbacks)
        done = 0
        while done < steps:
            chunk = min(update_steps, steps - done)
            with self._phase("train_chunk"):
                metrics = self.train_chunk(self.state, dataset, chunk)
                # one device-to-host copy a chunk; it waits for the chunk's work
                names = list(metrics)
                host = torch.stack([metrics[k] for k in names]).float().cpu().tolist()
            done += chunk
            current_step = self.state.step

            with self._phase("scalar_logging"):
                for i in range(chunk):
                    row = {k: host[j][i] for j, k in enumerate(names)}
                    self.history.append(row)
                    step = current_step - chunk + i
                    self.writer.scalars(row, log_utils.quantize_step(step, update_steps))

            show_eta(training_start, step_start, current_step, starting_step,
                     steps, update_steps, self.say)
            step_start = time.time()
            self._update_visualization(examples, current_step, update_steps, callbacks)

            # the reference's cadence (side2side_model.py:121-122)
            if current_step % (update_steps * 5) == 0 or done >= steps:
                with self._phase("checkpoint"):
                    self.saver.save(self.state)

        with self._phase("checkpoint"):
            self._flush_checkpoints()

        total = sum(self.phase_seconds.values())
        if total > 0:
            breakdown = "  ".join(
                f"{k} {v:.1f}s ({100 * v / total:.0f}%)"
                for k, v in sorted(self.phase_seconds.items(), key=lambda kv: -kv[1])
            )
            self.say(f"Phase breakdown: {breakdown}")

    # ----------------------------------------------------------------------
    def _update_visualization(self, examples, step, update_steps, callbacks):
        config = self.config
        qstep = log_utils.quantize_step(step, update_steps)
        save_name = os.path.join(
            config.temp_folder, "logs", config.architecture_name, config.model,
            self.now_string or "run", f"step_{step:06d}.png",
        )
        self.say(f"Previewing images generated at step {step} (3 test + 3 train)...")
        with self._phase("preview"):
            image = self.preview_generated_images(examples, save_name, step)
            self.writer.image(save_name, image, qstep)

        if "show_discriminator_output" in callbacks:
            self.say("Showing discriminator output patches (2 test + 2 train)...")
            with self._phase("discriminator_debug"):
                run_dir = os.path.dirname(save_name)
                for split in ("test", "train"):
                    prefix = os.path.join(run_dir, f"discriminated_{split}_step_{step:06d}")
                    images = self.show_discriminated_images(split, 2, save_prefix=prefix)
                    for i, img in enumerate(images):
                        self.writer.image(f"{prefix}_{i}.png", img, qstep)
        if "evaluate_l1" in callbacks:
            with self._phase("evaluate_l1"):
                l1_train, l1_test = self.report_l1(step=qstep)
            self.say(f"L1: {l1_train:.5f} / {l1_test:.5f} (train/test)")
        if "evaluate_fid" in callbacks:
            with self._phase("evaluate_fid"):
                fid_train, fid_test = self.report_fid(step=qstep)
            self.say(f"FID: {fid_train:.3f} / {fid_test:.3f} (train/test)")

    def _example(self, ds, i: int) -> tuple:
        if self.config.is_indexed:
            return ds.sources[i], ds.targets[i], ds.palettes[i]
        return ds.sources[i], ds.targets[i]

    def select_examples_for_visualization(self, number_of_examples: int = 6) -> list:
        """The first examples of the test split, then of the train split,
        half each (pix2pix_model.py:103-110); fewer where a split is
        smaller."""
        num_train = number_of_examples // 2
        num_test = number_of_examples - num_train
        return [
            self._example(ds, i)
            for ds, num in ((self.test_ds, num_test), (self.train_ds, num_train))
            for i in range(min(num, ds.n))
        ]

    @_float32_work
    @torch.no_grad()
    def preview_generated_images(self, examples, save_name=None, step=None) -> np.ndarray:
        """The [Input, Target, Generated] grid of `examples` (tuples from
        select_examples_for_visualization) as HWC uint8, written to
        `save_name` when one is given (on the writing rank)."""
        config = self.config
        save_name = self._written(save_name)
        drop = self._generator(preview_seed(config.seed, step or 0))
        src, tgt = (torch.stack([e[k] for e in examples]) for k in (0, 1))
        if config.is_indexed:
            palettes = torch.stack([e[2] for e in examples])
            fake = self.generate_fn(config, self.state.generator, src, drop)
            sources, targets, generated = (
                indexed_to_rgba(x, palettes).cpu().numpy() for x in (src, tgt, fake)
            )
            return viz.preview_grid(sources, targets, generated, save_name, step,
                                    values_in_unit_range=True)
        src, tgt = normalize(src.float()), normalize(tgt.float())
        fake = self.generate_fn(config, self.state.generator, src, drop)
        return viz.preview_grid(src.cpu().numpy(), tgt.cpu().numpy(),
                                fake.float().cpu().numpy(), save_name, step)

    @_float32_work
    @torch.no_grad()
    def show_discriminated_images(self, dataset_name: str = "test", num_images: int = 2,
                                  save_prefix: str | None = None) -> list[np.ndarray]:
        """The discriminator's patch maps on the first `num_images` pairs of
        a split, against their targets and their translations
        (pix2pix_model.py:161-229): one HWC uint8 strip each, written to
        `<save_prefix>_<i>.png` when a prefix is given. Prints each pair's
        two patch means, which the JAX figures show as titles."""
        config = self.config
        ds = self.test_ds if dataset_name == "test" else self.train_ds
        G, D = self.state.generator, self.state.discriminator
        outputs = []
        for i in range(min(num_images, ds.n)):
            drop = self._generator(config.seed + 1)
            src, tgt = ds.sources[i:i + 1], ds.targets[i:i + 1]
            if config.is_indexed:
                fake = self.generate_fn(config, G, src, drop)
                real_p = discriminate(config, D, tgt.float(), src.float())
                fake_p = discriminate(config, D, fake.float(), src.float())
                pal = ds.palettes[i]
                images = [indexed_to_rgba(x[0], pal) for x in (src, tgt, fake)]
            else:
                src, tgt = normalize(src.float()), normalize(tgt.float())
                fake = self.generate_fn(config, G, src, drop)
                real_p = discriminate(config, D, tgt, src)
                fake_p = discriminate(config, D, fake, src)
                images = [src[0], tgt[0], fake[0].float()]
            source, target, generated = (x.cpu().numpy() for x in images)
            real_p, fake_p = real_p[0].cpu().numpy(), fake_p[0].cpu().numpy()
            self.say(f"{dataset_name} pair {i}: discriminated target {np.mean(real_p):.3f}, "
                      f"discriminated generated {np.mean(fake_p):.3f}")
            outputs.append(viz.discriminator_debug_figure(
                source, target, generated, real_p, fake_p,
                save_name=self._written(f"{save_prefix}_{i}.png") if save_prefix else None,
                values_in_unit_range=config.is_indexed,
            ))
        return outputs

    # -- evaluation ---------------------------------------------------------
    @_float32_work
    def report_l1(self, num_images: int | None = None, step: int | None = None):
        """(train, test) L1 over the first num_images of each split
        (default: the test split's size)."""
        if num_images is None:
            num_images = sum(self.config.test_sizes)
        values = eval_metrics.report_l1(
            self.config, self.state.generator, self.train_ds, self.test_ds, num_images,
            # the JAX Trainer's L1 seed; training's generators take seed
            # + 4 and + 5 (train/state.py::create_train_state)
            self.config.seed + 2,
            generate_fn=self.generate_fn,
        )
        if self.writer is not None and step is not None:
            self.writer.scalars(
                {"l1-evaluation/train": values[0], "l1-evaluation/test": values[1]}, step
            )
        return values

    @_float32_work
    def report_fid(self, num_images: int | None = None, step: int | None = None):
        """(train, test) FID between the first num_images targets of each
        split and their translations (default: the test split's size). The
        translations draw their dropout masks, the train split's then the
        test split's, from one generator seeded seed + 3 (the JAX Trainer's
        FID seed), never from the state's."""
        if num_images is None:
            num_images = sum(self.config.test_sizes)
        if self.fid is None:
            self.fid = FidEvaluator(device=self.device, group=self.group)
        drop = self._generator(self.config.seed + 3)
        values = []
        for ds in (self.train_ds, self.test_ds):
            real, fake = eval_metrics.generate_split(
                self.config, self.state.generator, ds, num_images, drop, self.generate_fn
            )
            values.append(self.fid.compare(real, fake))
        if self.writer is not None and step is not None:
            self.writer.scalars({"fid/train": values[0], "fid/test": values[1]}, step)
        return values[0], values[1]

    # -- image dumps (side2side_model.py:202-222) ---------------------------
    @_float32_work
    def generate_images_from_dataset(self, dataset_name: str = "test",
                                     num_images: int | None = None, steps=None) -> str:
        """One [Input, Target, Generated] PNG per pair of a split, 0.png
        to <n - 1>.png, in a folder emptied first; returns the folder."""
        config = self.config
        ds = self.test_ds if dataset_name == "test" else self.train_ds
        n = ds.n if num_images is None else min(num_images, ds.n)
        base = os.path.join(
            config.temp_folder, "generated-images", config.architecture_name, config.model
        )
        if self._written(base):
            delete_folder(base)
            ensure_folder_structure(base)
        for i in range(n):
            self.preview_generated_images(
                [self._example(ds, i)], os.path.join(base, f"{i}.png"), steps
            )
        self.say(f'Generated {n} images (using "{dataset_name}" dataset)')
        return base

    # -- weights (side2side_model.py:178-200) -------------------------------
    def _save_params(self, which: str, module) -> str:
        """The writing rank writes; no rank returns before the file is there."""
        path = ckpt.params_path(self.config, which)
        if self._written(path):
            ckpt.save_params(self.config, which, module)
        if self.group is not None:
            self.group.barrier()
        return path

    def save_generator(self) -> str:
        return self._save_params("generator", self.state.generator)

    def load_generator(self) -> None:
        ckpt.load_params(self.config, "generator", self.state.generator)
        self._replicate()

    def save_discriminator(self) -> str:
        return self._save_params("discriminator", self.state.discriminator)

    def load_discriminator(self) -> None:
        ckpt.load_params(self.config, "discriminator", self.state.discriminator)
        self._replicate()

    def import_network_params(self, generator_npz: str | None = None,
                              discriminator_npz: str | None = None) -> None:
        """Load converted reference weights (the '/'-joined Flax .npz of
        models/convert.py::save_params_npz) into the live state, e.g. to
        fine-tune or generate from a model trained with the TF reference.
        Strict: a missing, extra or mis-shaped key raises ValueError naming
        it, before anything changes. The imported network's optimizer
        state and the step reset to zero: this is a weight import, not a
        resume."""
        state = self.state
        loads = []
        for npz, module, optimizer, bridge in (
            (generator_npz, state.generator, state.g_optimizer,
             convert.generator_state_dict_from_flax),
            (discriminator_npz, state.discriminator, state.d_optimizer,
             convert.discriminator_state_dict_from_flax),
        ):
            if npz:
                loads.append((module, optimizer, bridge(convert.load_params_npz(npz), module)))
        for module, optimizer, state_dict in loads:
            module.load_state_dict(state_dict)
            optimizer.reset()
        if loads:
            state.step = 0
        self._replicate()

    def restore_latest_checkpoint(self) -> int:
        """Resume from the latest checkpoint (read on every rank); returns
        the restored step."""
        self.manager.restore(self.state)
        self._replicate()
        return self.state.step
