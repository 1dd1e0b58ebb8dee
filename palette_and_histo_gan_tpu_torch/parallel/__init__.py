"""Data parallelism over torch.distributed: the process group, the
data-parallel group and its collectives, the data-parallel step, chunk and
generate, and the launcher of a local world of ranks (launch.py)."""

from .distributed import global_mesh_info, initialize, shutdown
from .dp import make_dp_generate_fn, make_dp_train_chunk, make_dp_train_step
from .mesh import DataGroup, make_group, replicate_state, replicated, shard_batch

__all__ = [
    "global_mesh_info",
    "initialize",
    "shutdown",
    "make_dp_generate_fn",
    "make_dp_train_chunk",
    "make_dp_train_step",
    "DataGroup",
    "make_group",
    "replicate_state",
    "replicated",
    "shard_batch",
]
