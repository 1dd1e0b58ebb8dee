"""The process group: one process a rank, joined by torch.distributed.

Counterpart of palette_and_histo_gan_tpu/parallel/distributed.py. Where
JAX joins hosts and XLA moves the data between devices, here every rank is
one process on one device and torch.distributed carries the collectives:
NCCL between cards, Gloo between CPU processes. Gloo also takes CUDA
tensors for broadcast and all_reduce, the only collectives the port uses,
which lets several ranks share one card; a card runs Gloo only when the
caller names it. There is no fallback: a CUDA device without NCCL, or a
failed NCCL init, raises.

By default `initialize` reads torchrun's environment (`env://`: RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT). Without it, and without
an `init_method`, it forms a world of one process on a file rendezvous in
a temporary directory.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile

import torch
import torch.distributed as dist

# set by initialize: the device this process's rank computes on, and the
# temporary directory of a world of one (removed by shutdown)
_device: torch.device | None = None
_rendezvous_dir: str | None = None


def torchrun_world_size() -> int:
    """WORLD_SIZE of torchrun's environment; 1 outside torchrun."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def local_rank() -> int:
    """LOCAL_RANK of torchrun's environment; 0 outside torchrun."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def rank_device(device: torch.device | str) -> torch.device:
    """A rank's device: under torchrun "cuda" without an index means
    cuda:LOCAL_RANK; anything else stays as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", local_rank())
    return device


def initialize(backend: str | None = None, init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               device: torch.device | str = "cuda",
               timeout: datetime.timedelta | None = None) -> torch.device:
    """Join this process to the default process group; returns its device.

    backend: "nccl" (the default on a CUDA device) or "gloo" (the default
    on the CPU; on a CUDA device only when named, for ranks that share a
    card). init_method: torchrun's "env://" when its environment is set,
    else a file rendezvous for a world of one. device: under torchrun
    "cuda" is cuda:LOCAL_RANK (rank_device); a card becomes the current
    device. A no-op that returns the device when the group exists."""
    global _device, _rendezvous_dir
    if dist.is_initialized():
        return _device if _device is not None else rank_device(device)
    device = rank_device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} asked for, but PyTorch sees no CUDA device")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL runs on CUDA devices, not on {device}")
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("this PyTorch has no NCCL; Gloo on a card only when named")
    if init_method is None:
        if "WORLD_SIZE" in os.environ:
            init_method = "env://"
        elif world_size not in (None, 1):
            raise ValueError(f"world_size={world_size} needs an init_method or torchrun")
        else:
            _rendezvous_dir = tempfile.mkdtemp(prefix="phg-rendezvous-")
            init_method = "file://" + os.path.join(_rendezvous_dir, "store")
            world_size, rank = 1, 0
    kwargs = {}
    if world_size is not None:
        kwargs.update(world_size=world_size, rank=rank)
    if timeout is not None:
        kwargs["timeout"] = timeout
    if backend == "nccl":
        kwargs["device_id"] = device  # NCCL's communicator forms here, or raises here
    dist.init_process_group(backend, init_method=init_method, **kwargs)
    _device = device
    return device


def global_mesh_info() -> dict:
    """This rank's rank, the world size, its local rank, its device and the
    backend: what JAX's global_mesh_info reports of processes and devices."""
    if not dist.is_initialized():
        raise RuntimeError("no process group; call initialize() first")
    return {
        "rank": dist.get_rank(),
        "world_size": dist.get_world_size(),
        "local_rank": local_rank(),
        "device": str(_device),
        "backend": dist.get_backend(),
    }


def shutdown() -> None:
    """Leave and destroy the default process group, if there is one."""
    global _device, _rendezvous_dir
    if dist.is_initialized():
        dist.destroy_process_group()
    if _rendezvous_dir is not None:
        shutil.rmtree(_rendezvous_dir, ignore_errors=True)
    _device = _rendezvous_dir = None
