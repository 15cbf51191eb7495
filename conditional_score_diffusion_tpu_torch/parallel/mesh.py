"""Process group, batch rows and collectives of the data-parallel port
(JAX `parallel/mesh.py`).

JAX's counterparts and what stands for them here:

* ``make_mesh`` -> :func:`init_distributed`: join the process group of a
  ``torchrun`` launch (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR`` / ``MASTER_PORT``) or of an explicit ``init_method``
  (``file://`` or ``tcp://``), NCCL on ``cuda`` and gloo on ``cpu``;
  :func:`rank`, :func:`world_size` (0 and 1 with no process group).
* ``local_batch_to_global`` -> :func:`local_batch`: this rank's rows of the
  global batch, which every rank assembles; a batch that does not split
  evenly raises, as JAX's ``NamedSharding`` does.
* ``shard_train_step`` -> `training/steps.py`: each rank draws the global
  batch's noise, keeps its rows, and one :func:`all_reduce_mean_` of the
  gradients (and the loss) before the clip stands where XLA's psum sits;
  :func:`broadcast_state` makes every rank start from rank 0's state.
* ``shard_sampling_fn`` -> :func:`shard_sampling_fn`: the sampler runs on
  this rank's rows of ``y`` with a noise source that draws the global shape
  and keeps the rank's rows (:func:`sharded_noise`), and the samples are
  all-gathered (:func:`all_gather_rows`), so every rank returns the global
  batch that the unsharded call returns.

With no process group nothing here is called and the port runs as one
process.  No layer of the port has statistics across samples (GroupNorm and
the InstanceNorm++ family are per sample; the Inception BatchNorm is folded
and eval-only), so splitting a batch by rows changes no sample's result.
One sampler step does couple the samples: the Langevin corrector's step
size takes the batch's mean score and noise norms.  Inside a sharded
sampler call :func:`batch_mean` takes that mean over every rank's rows (an
all-reduce), as XLA's global mean does under JAX's sharding.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Callable, Iterable, List, Mapping, Optional

import torch
import torch.distributed as dist

# set inside a `shard_sampling_fn` call: the batch's rows are spread over the ranks
_SHARDED_ROWS = contextvars.ContextVar("sharded_rows", default=False)


def is_distributed() -> bool:
    """Whether this process belongs to an initialized process group."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def init_distributed(device="cuda", init_method: Optional[str] = None, rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Join the process group and return this rank's device.

    ``rank`` and ``world_size`` default to the ``RANK`` / ``WORLD_SIZE``
    variables that ``torchrun`` sets (0 and 1 without them), and
    ``init_method`` to ``env://`` (``MASTER_ADDR`` / ``MASTER_PORT``).  On
    ``cuda`` the device becomes ``cuda:LOCAL_RANK`` (``LOCAL_RANK``
    defaults to the rank) and the backend NCCL; on ``cpu`` the backend is
    gloo.  Leave the group with ``torch.distributed.destroy_process_group``.
    """
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank, world_size=world_size)
    return device


def local_batch(batch, rank: int, world: int):
    """Rows ``[rank * B / world, (rank + 1) * B / world)`` of a batch (a
    tensor or array, or a dict of them); B must split evenly."""

    def rows(x):
        B = x.shape[0]
        if B % world:
            raise ValueError(f"a batch of {B} does not split evenly over {world} ranks")
        n = B // world
        return x[rank * n:(rank + 1) * n]

    if isinstance(batch, Mapping):
        return {k: rows(v) for k, v in batch.items()}
    return rows(batch)


def all_reduce_mean_(tensors: List[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the ranks, in place: one
    all-reduce (SUM) of one flat buffer of them all, divided by the world
    size.  The tensors share one dtype and device."""
    if len({t.dtype for t in tensors}) != 1:
        raise TypeError(f"all_reduce_mean_ needs one dtype, got {sorted({str(t.dtype) for t in tensors})}")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat.div_(world_size())
    torch._foreach_copy_(tensors, [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in tensors]), tensors)])


def broadcast_state(tensors: Iterable[torch.Tensor]) -> None:
    """Overwrite ``tensors`` (parameters, buffers, EMA copies, in the same
    order on every rank) with rank 0's, one broadcast per dtype."""
    groups = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t.detach())
    with torch.no_grad():
        for group in groups.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.broadcast(flat, src=0)
            torch._foreach_copy_(group, [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in group]), group)])


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in rank order."""
    parts = [torch.empty_like(x) for _ in range(world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def batch_mean(v: torch.Tensor) -> torch.Tensor:
    """The mean of a per-row vector over the batch: inside a sharded
    sampler call, over every rank's rows (each rank's mean, all-reduced and
    divided by the world size; the rows split evenly)."""
    mean = v.mean()
    if not _SHARDED_ROWS.get():
        return mean
    mean = mean.reshape(1)
    all_reduce_mean_([mean])
    return mean.reshape(())


@contextlib.contextmanager
def _sharded_rows():
    token = _SHARDED_ROWS.set(True)
    try:
        yield
    finally:
        _SHARDED_ROWS.reset(token)


def sharded_noise(noise: Callable, rank: int, world: int) -> Callable:
    """A noise source that, asked for ``(b, ...)``, draws ``(b * world,
    ...)`` from ``noise`` and returns this rank's ``b`` rows: the draws the
    unsharded sampler makes for the same rows."""

    def draw(shape):
        b, *rest = tuple(shape)
        return noise((b * world, *rest))[rank * b:(rank + 1) * b]

    return draw


def shard_sampling_fn(sampling_fn: Callable) -> Callable:
    """``fn(noise, model, y=None, **kw) -> (samples, info)`` of a sampler
    built for this rank's rows (its shape's batch the global one over the
    world size): it samples this rank's rows of ``y`` with
    :func:`sharded_noise` and all-gathers the samples, so every rank
    returns the global batch; ``info`` is this rank's.  Inside the call
    :func:`batch_mean` reduces over the ranks."""
    from ..sampling.pc import gaussian_noise

    r, w = rank(), world_size()

    def fn(noise, model, y=None, **kwargs):
        if isinstance(noise, torch.Generator):
            noise = gaussian_noise(noise)
        noise = sharded_noise(noise, r, w)
        with _sharded_rows():
            if y is None:
                samples, info = sampling_fn(noise, model, **kwargs)
            else:
                samples, info = sampling_fn(noise, model, local_batch(y, r, w), **kwargs)
        return all_gather_rows(samples), info

    return fn
