"""Data parallelism over `torch.distributed` (JAX `parallel/`).

JAX runs one program on a 1-D ``('data',)`` mesh: the batch sharded on its
leading axis, the state replicated, and XLA inserts the gradient psum.  The
port runs one process per card (``torchrun``) with the same contract: a step
at world W computes what the world-1 step computes on the global batch.
"""

from .mesh import (
    all_gather_rows,
    all_reduce_mean_,
    batch_mean,
    broadcast_state,
    init_distributed,
    is_distributed,
    local_batch,
    rank,
    shard_sampling_fn,
    sharded_noise,
    world_size,
)

__all__ = [
    "init_distributed",
    "is_distributed",
    "rank",
    "world_size",
    "local_batch",
    "all_reduce_mean_",
    "all_gather_rows",
    "batch_mean",
    "broadcast_state",
    "sharded_noise",
    "shard_sampling_fn",
]
