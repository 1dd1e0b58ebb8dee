"""The data-parallel group and what it does with tensors.

Counterpart of palette_and_histo_gan_tpu/parallel/mesh.py. Where JAX names
a sharding and lets XLA place the arrays, a `DataGroup` (make_mesh's
counterpart) is the process group, the world size, this rank and its
device, and its methods are the collectives the port needs:
  * `batch_slice` / `shard_batch`: this rank's contiguous rows of a global
    batch;
  * `replicated` / `replicate_state`: rank 0's values on every rank
    (parameters, both KerasAdam moments and step counts, the step, the
    augmentation and dropout generators' states);
  * `all_reduce_mean_`: one flat buffer of many tensors, summed over the
    ranks and divided by the world size (gradients, metrics);
  * `gather_rows`: every rank's rows of a batch on every rank;
  * `sum_across`: a differentiable sum over the ranks (the global
    Hellinger loss, ops/histogram.py).
Only `broadcast` and `all_reduce` are used, the two collectives Gloo runs
on CUDA tensors, so that ranks may share a card over Gloo. A gather is an
all_reduce (sum) of a zeroed full-size buffer into which each rank writes
its rows, which is exact. The JAX mesh's size-1 "model" axis has no
counterpart: nothing shards a parameter.

`collectives` counts the calls and bytes of each collective this process
ran, always (`reset_collectives` zeroes them).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .distributed import initialize

# calls and bytes of each collective this process ran; callers that count
# a run zero them first (reset_collectives)
collectives = {"all_reduce": {"calls": 0, "bytes": 0}, "broadcast": {"calls": 0, "bytes": 0}}


def reset_collectives() -> None:
    for counts in collectives.values():
        counts.update(calls=0, bytes=0)


def _count(kind: str, tensor: torch.Tensor) -> None:
    collectives[kind]["calls"] += 1
    collectives[kind]["bytes"] += tensor.nbytes


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflatten_into(flat: torch.Tensor, tensors) -> None:
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """The ranks of the default process group, which split a batch: each
    holds the same parameters and takes `batch_slice` of every global
    batch."""

    world_size: int
    rank: int
    device: torch.device

    def batch_slice(self, global_b: int) -> slice:
        """This rank's contiguous rows of a batch of `global_b` rows."""
        if global_b % self.world_size:
            raise ValueError(f"a batch of {global_b} does not split over {self.world_size} ranks")
        per = global_b // self.world_size
        return slice(self.rank * per, (self.rank + 1) * per)

    def all_reduce_(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum `tensor` over the ranks, in place."""
        dist.all_reduce(tensor)
        _count("all_reduce", tensor)
        return tensor

    def broadcast_(self, tensors) -> None:
        """Rank 0's values of same-dtype tensors on every rank, in place,
        in one collective."""
        tensors = list(tensors)
        if not tensors:
            return
        flat = _flat(tensors).to(self.device)
        dist.broadcast(flat, 0)
        _count("broadcast", flat)
        _unflatten_into(flat, tensors)

    def all_reduce_mean_(self, tensors) -> None:
        """The mean over the ranks of same-dtype tensors, in place, in one
        collective."""
        tensors = list(tensors)
        if not tensors:
            return
        flat = self.all_reduce_(_flat(tensors))
        _unflatten_into(flat.div_(self.world_size), tensors)

    def gather_rows(self, local: torch.Tensor, total_rows: int) -> torch.Tensor:
        """The (total_rows, ...) batch whose rows rank r holds from
        r * len(local) on (rows past total_rows dropped), on every rank."""
        per = local.shape[0]
        full = local.new_zeros((per * self.world_size, *local.shape[1:]))
        full[self.rank * per:(self.rank + 1) * per] = local
        return self.all_reduce_(full)[:total_rows]

    def sum_across(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of `x` over the ranks, differentiable."""
        return _SumAcross.apply(x, self)

    def barrier(self) -> None:
        """Return when every rank got here (an all_reduce: Gloo on a card
        runs nothing else)."""
        self.all_reduce_(torch.zeros(1, device=self.device))


class _SumAcross(torch.autograd.Function):
    """Forward: the all_reduce sum. Backward: the cotangent times the world
    size. Every rank computes the same loss from the same sum, so the
    cotangent is the same on every rank, and the sum of the ranks'
    cotangents, which the gradient of the sum is, is N times it; after the
    gradients' mean all_reduce each rank's share is then that of one
    process. (The identity backward would leave it 1/N of that.)"""

    @staticmethod
    def forward(ctx, x, data_group):
        ctx.world_size = data_group.world_size
        return data_group.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g * ctx.world_size, None


def make_group(device: torch.device | str = "cuda", **init_kwargs) -> DataGroup:
    """The DataGroup of the default process group, which
    distributed.initialize forms first if there is none (with
    `init_kwargs`); `device` is this rank's (distributed.rank_device)."""
    device = initialize(device=device, **init_kwargs)
    return DataGroup(dist.get_world_size(), dist.get_rank(), device)


def shard_batch(group: DataGroup, batch):
    """This rank's rows of a global batch: a tensor or a tuple of them."""
    if isinstance(batch, torch.Tensor):
        return batch[group.batch_slice(batch.shape[0])]
    return tuple(shard_batch(group, x) for x in batch)


def replicated(group: DataGroup, tensor: torch.Tensor) -> torch.Tensor:
    """Rank 0's value of `tensor` on every rank, in place; returns it."""
    group.broadcast_([tensor])
    return tensor


@torch.no_grad()
def replicate_state(group: DataGroup, state) -> None:
    """Rank 0's TrainState on every rank, in place: each network's
    parameters with both KerasAdam moments in one broadcast, the step and
    the optimizers' step counts in one, both generators' states in one."""
    counts = [state.step]
    for module, optimizer in ((state.generator, state.g_optimizer),
                              (state.discriminator, state.d_optimizer)):
        params = list(module.parameters())
        moments = [optimizer.state[p][k] for k in ("m", "v") for p in params]
        group.broadcast_(params + moments)
        counts += [optimizer.state[p]["step"] for p in params]
    counts = replicated(group, torch.tensor(counts, dtype=torch.int64, device=group.device))
    counts = counts.tolist()
    state.step = counts.pop(0)
    for module, optimizer in ((state.generator, state.g_optimizer),
                              (state.discriminator, state.d_optimizer)):
        for p in module.parameters():
            optimizer.state[p]["step"] = counts.pop(0)
    generators = (state.aug_generator, state.dropout_generator)
    rng = torch.stack([g.get_state() for g in generators]).to(group.device)
    replicated(group, rng)
    for g, value in zip(generators, rng.cpu()):
        g.set_state(value.clone())  # a tensor of its own: set_state reads its storage
