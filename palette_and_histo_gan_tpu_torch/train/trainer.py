"""Training loop: chunked steps, per-step scalars, ETA, L1 evaluation.

Mirrors palette_and_histo_gan_tpu/train/trainer.py:59-240 (`Trainer.fit`):
training runs in chunks of `update_steps` steps whose metrics stay on the
device and come to the host once per chunk; between chunks the host writes
the per-step scalars at the reference's quantized step (utils/logging.py),
prints the ETA and, with the "evaluate_l1" callback, the train/test L1.
`phase_seconds` accumulates wall time per phase.

Not ported yet (ROADMAP.md, Queue 1): preview grids, checkpoints, weight
export, FID and the discriminator debug maps. The callbacks that ask for
them raise NotImplementedError.
"""

from __future__ import annotations

import contextlib
import time
from typing import Sequence

import torch

from ..config import Config, check_supported
from ..data.loader import IndexedDataset, RgbaDataset, make_indexed_datasets, make_rgba_datasets
from ..eval import metrics as eval_metrics
from ..utils import logging as log_utils
from ..utils.io import seconds_to_human_readable
from .state import TrainState, create_train_state, param_count
from .steps import make_train_chunk

SUPPORTED_CALLBACKS = ("evaluate_l1",)


def show_eta(training_start_time, step_start_time, current_step, starting_step,
             total_steps, update_steps):
    """ETA printer (reference side2side_model.py:14-25)."""
    now = time.time()
    elapsed = now - training_start_time
    steps_so_far = float(current_step - starting_step)
    eta = elapsed / (steps_so_far + 1.0) * (total_steps - steps_so_far)
    print(f"Time since start: {seconds_to_human_readable(elapsed)}")
    print(f"Estimated time to finish: {seconds_to_human_readable(eta)}")
    print(f"Last {update_steps} steps took: {now - step_start_time:.2f}s\n")


class Trainer:
    """Training loop of any variant on one explicit device.

    `datasets` is a (train, test) pair already on `device`: RgbaDatasets
    (data.loader.datasets_from_arrays) or, for the indexed variant,
    IndexedDatasets (data.loader.indexed_datasets_from_arrays). By default
    the splits are decoded from config's dataset roots (and, for the
    indexed variant, indexed on the device through kernel K5). There is no
    fallback between devices: "cuda" without a card raises.
    """

    def __init__(self, config: Config, device: torch.device | str,
                 datasets: tuple | None = None):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("device 'cuda' asked for, but PyTorch sees no CUDA device")
            if self.device.index is None:  # tensors report "cuda:N", never "cuda"
                self.device = torch.device("cuda", torch.cuda.current_device())
        check_supported(config, self.device)
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
        print(f"Generator: unet-gen with {param_count(self.state.generator):,} parameters")
        print(
            f"Discriminator: patch-disc with "
            f"{param_count(self.state.discriminator):,} parameters"
        )
        self.train_chunk = make_train_chunk(config, self.train_ds.n, config.seed)
        self.writer = None
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

    def fit(self, steps: int | None = None, update_steps: int | None = None,
            callbacks: Sequence[str] = ()):
        config = self.config
        steps = config.steps if steps is None else steps
        update_steps = config.update_steps if update_steps is None else update_steps
        unsupported = [c for c in callbacks if c not in SUPPORTED_CALLBACKS]
        if unsupported:
            raise NotImplementedError(
                f"callbacks {unsupported} are not ported yet (ROADMAP.md, Queue 1); "
                f"supported: {SUPPORTED_CALLBACKS}"
            )
        if self.writer is None:
            self.writer, _ = log_utils.make_writer(config)
        try:
            self._do_fit(steps, update_steps, callbacks)
        finally:
            self.writer.flush()

    def _do_fit(self, steps, update_steps, callbacks):
        starting_step = self.state.step
        training_start = step_start = time.time()
        dataset = (self.train_ds.sources, self.train_ds.targets)
        if "evaluate_l1" in callbacks:
            self._evaluate_l1(starting_step, update_steps)
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
                     steps, update_steps)
            step_start = time.time()
            if "evaluate_l1" in callbacks:
                self._evaluate_l1(current_step, update_steps)

        total = sum(self.phase_seconds.values())
        if total > 0:
            breakdown = "  ".join(
                f"{k} {v:.1f}s ({100 * v / total:.0f}%)"
                for k, v in sorted(self.phase_seconds.items(), key=lambda kv: -kv[1])
            )
            print(f"Phase breakdown: {breakdown}")

    def _evaluate_l1(self, step: int, update_steps: int):
        with self._phase("evaluate_l1"):
            l1_train, l1_test = self.report_l1(
                step=log_utils.quantize_step(step, update_steps)
            )
        print(f"L1: {l1_train:.5f} / {l1_test:.5f} (train/test)")

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
        )
        if self.writer is not None and step is not None:
            self.writer.scalars(
                {"l1-evaluation/train": values[0], "l1-evaluation/test": values[1]}, step
            )
        return values
