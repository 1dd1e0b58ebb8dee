"""Checkpoints of the whole train state, and the networks' weight files.

Counterpart of palette_and_histo_gan_tpu/train/checkpoint.py, built on
`torch.save` / `torch.load(weights_only=True)` where that one uses orbax:
  - `checkpoint_dir(config)`: <temp>/training-checkpoints/<arch>/<model>;
  - `CheckpointManager`: one file `step_<step>.pt` a checkpoint, holding
    `TrainState.state_dict()` (both networks, both optimizers' moments and
    step counts, both generators' states, the step). A write goes to a
    temporary name and is renamed; only the newest is kept, an older one
    removed only after the new one has landed. `restore` loads the newest
    into a state in place and leaves the state as it is when there is
    none;
  - `AsyncSaver`: saves that keep the training loop waiting only for a
    device copy of the state (below);
  - `save_params` / `load_params`: models/py/<which>/<arch>/<model>/
    params.pt, the module's state_dict, beside the JAX package's
    params.msgpack in the same folder.
Under data parallelism (train/trainer.py) only rank 0 has an AsyncSaver
and writes, and the final flush ends in a barrier, so that no rank returns
before the file exists; a restore reads the file on every rank and then
replicates rank 0's state (parallel/mesh.py::replicate_state).
"""

from __future__ import annotations

import os
import re
import tempfile
from concurrent.futures import Future, ThreadPoolExecutor

import torch
from torch import nn

from ..config import Config
from .state import TrainState

_CHECKPOINT_NAME = re.compile(r"step_(\d+)\.pt")


def checkpoint_dir(config: Config) -> str:
    return os.path.abspath(
        os.path.join(
            config.temp_folder, "training-checkpoints", config.architecture_name, config.model
        )
    )


class CheckpointManager:
    """The checkpoints of one directory, `step_<step>.pt` each."""

    def __init__(self, directory: str):
        self.directory = directory

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}.pt")

    def steps(self) -> list[int]:
        """The steps of the checkpoints on disk, oldest first."""
        if not os.path.isdir(self.directory):
            return []
        found = (_CHECKPOINT_NAME.fullmatch(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, host_state: dict) -> None:
        """Write a state_dict of host tensors as the checkpoint of `step`."""
        os.makedirs(self.directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=".step_", suffix=".tmp", dir=self.directory)
        try:
            with os.fdopen(fd, "wb") as f:
                torch.save(host_state, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path(step))
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        for old in self.steps()[:-1]:
            os.remove(self.path(old))

    def restore(self, state: TrainState) -> TrainState:
        """Load the newest checkpoint into `state` in place; `state` as it
        is when there is none."""
        step = self.latest_step()
        if step is None:
            return state
        state.load_state_dict(
            torch.load(self.path(step), map_location="cpu", weights_only=True)
        )
        return state


def make_manager(config: Config) -> CheckpointManager:
    return CheckpointManager(checkpoint_dir(config))


def _map_tensors(tree: dict, fn) -> dict:
    return {
        k: _map_tensors(v, fn) if isinstance(v, dict)
        else fn(v) if isinstance(v, torch.Tensor) else v
        for k, v in tree.items()
    }


class AsyncSaver:
    """Checkpoint saves that overlap the device-to-host copy and the disk
    write with training (the JAX AsyncSaver's semantics).

    `save(state)` first hands the pending snapshot to the writer thread.
    It then copies every tensor of the state on the device, on the current
    stream, so after the chunk's last kernel and before the next chunk
    updates the parameters in place; copies that snapshot into pinned host
    buffers without blocking on a side stream; records an event there and
    returns. The snapshot's disk write is issued at the next `save()` or at
    `flush()`, after the event is done, and runs on one writer thread. A
    failed write raises at the next `save()` or at `flush()`. On the CPU
    the snapshot is a plain copy.
    """

    def __init__(self, manager: CheckpointManager):
        self.manager = manager
        self._pending: tuple | None = None  # (step, host tree, event, device copy)
        self._writes: list[Future] = []
        self._writer: ThreadPoolExecutor | None = None
        self._stream = None

    def save(self, state: TrainState) -> None:
        self._flush_pending()
        self._reap(wait=False)
        live = state.state_dict()
        device = next(state.generator.parameters()).device
        if device.type != "cuda":
            self._pending = (state.step, _map_tensors(live, torch.clone), None, None)
            return
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        snapshot = _map_tensors(live, torch.clone)  # on the current stream
        self._stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(self._stream):
            host = _map_tensors(snapshot, lambda t: t if t.device.type == "cpu" else (
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
            ))
            event = torch.cuda.Event()
            event.record(self._stream)
        # the device copy stays referenced until the event is done
        self._pending = (state.step, host, event, snapshot)

    def _flush_pending(self) -> None:
        if self._pending is None:
            return
        step, host, event, _device_copy = self._pending
        self._pending = None
        if event is not None:
            event.synchronize()  # before the device copy is released
        if self._writer is None:
            self._writer = ThreadPoolExecutor(1, thread_name_prefix="checkpoint-writer")
        self._writes.append(self._writer.submit(self.manager.save, step, host))

    def _reap(self, wait: bool) -> None:
        """Drop finished writes, raising the first failure; with `wait`,
        every write first lands."""
        while self._writes and (wait or self._writes[0].done()):
            self._writes.pop(0).result()

    def wait(self) -> None:
        """Block until every issued write has landed (the pending snapshot
        stays pending)."""
        self._reap(wait=True)

    def flush(self) -> None:
        """Write the pending snapshot and block until all writes land."""
        self._flush_pending()
        self._reap(wait=True)


# --------------------------------------------------------------------------
# The networks' weight files (the reference's SavedModel export)
# --------------------------------------------------------------------------


def _export_path(config: Config, which: str) -> str:
    return os.path.join("models", "py", which, config.architecture_name, config.model)


def params_path(config: Config, which: str) -> str:
    """models/py/<which>/<arch>/<model>/params.pt."""
    return os.path.join(_export_path(config, which), "params.pt")


def save_params(config: Config, which: str, module: nn.Module) -> str:
    """Write a network's state_dict (which: 'generator' | 'discriminator')
    as params.pt; returns the path."""
    out = params_path(config, which)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in module.state_dict().items()}, out)
    return out


def load_params(config: Config, which: str, module: nn.Module) -> None:
    """Load a network's params.pt into `module` in place (strict)."""
    path = params_path(config, which)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {which} weights at {os.path.abspath(path)}")
    module.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))


def params_equal(a: nn.Module | dict, b: nn.Module | dict) -> bool:
    """Two modules (or state_dicts) hold the same keys and the same values."""
    a = a.state_dict() if isinstance(a, nn.Module) else a
    b = b.state_dict() if isinstance(b, nn.Module) else b
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k].cpu(), b[k].cpu()) for k in a
    )
