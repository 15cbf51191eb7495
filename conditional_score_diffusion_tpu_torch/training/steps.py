"""Train and eval steps (JAX `training/steps.py`).

The JAX step is one pure function ``(state, batch, rng) -> (state,
metrics)``; here ``train_step(state, batch)`` updates the state in place:
the loss and its gradients by autograd (with exact gradient accumulation),
the global norm before clipping, optax's clip, the Adam or AdamW update
under the warmup schedule, and the EMA step.  It returns the metrics
``loss`` and ``grad_norm`` as 0-d tensors on the device (reading them
synchronizes).

Randomness is a function of ``(config.seed, step)``, as the JAX step folds
the step into its key: t and the noise of micro-batch ``i`` are the loss's
``draws`` from a generator seeded with :func:`step_seed`, and dropout draws
from torch's default generator, which :func:`seeded` seeds the same way and
restores after.  A run restored from a checkpoint therefore continues bit
for bit on the same device.  The draws are torch's, not jax.random's; the
parity tests inject the JAX key chain's ``t`` and noise instead
(``noise=``).

Data parallel (a process group of `parallel`, JAX's sharded step): both
steps take the global batch (and the global ``noise``).  Each rank makes
the draws for the global batch, as one process would, and keeps its rows of
both (with no process group, all rows); after the accumulation loop one
all-reduce averages the gradients and the loss over the ranks, where XLA's
psum sits, so the norm, the clip, Adam and the EMA see the global gradient
on every rank.  Dropout draws from a seed that folds in the rank
(micro-batch index ``i + rank * accum``), so ranks do not share masks; rank
0's is the world-1 seed.  The eval step returns the loss's mean over the
ranks; a batch that does not split evenly is evaluated whole on every rank.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional

import torch

from .. import parallel
from ..losses import build_loss_fn
from ..losses.continuous import shapes_of
from ..models.ema import ema_update
from ..sde import build_sde
from .schedules import is_decreasing_variance, sigma_y_at_step
from .state import TrainState, clip_by_global_norm_, global_norm


def step_seed(seed: int, step: int, index: int = 0) -> int:
    """A 63-bit seed for micro-batch (or eval batch) ``index`` of ``step``."""
    return (((seed + 1) * 1_000_003 + step) * 1_009 + index) % (2**63 - 1)


@contextlib.contextmanager
def seeded(seed: int, device: torch.device):
    """Seed torch's default generators of the CPU and ``device`` with
    ``seed`` for the block and restore their states after it."""
    devices = [device.index if device.index is not None else torch.cuda.current_device()] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=devices, device_type="cuda"):
        torch.manual_seed(seed)
        yield


def make_sde_for_step(config, data_mean=None) -> Callable:
    """``sde_fn(step) -> sde``: static for most recipes; for VS-CMDE the
    sigma_y of the SDE follows the schedule of ``step``."""
    if is_decreasing_variance(config):

        def sde_fn(step):
            smin_y, smax_y = sigma_y_at_step(config, step)
            return build_sde(config, data_mean=data_mean, sigma_min_y=smin_y, sigma_max_y=smax_y)[0]

        return sde_fn
    sde, _ = build_sde(config, data_mean=data_mean)
    return lambda step: sde


def apply_gradients(state: TrainState, named_params) -> torch.Tensor:
    """The update of the gradients held in ``.grad`` of ``named_params``:
    their global norm (returned, before clipping), optax's clip, the Adam
    or AdamW step under the warmup schedule and the EMA step."""
    named_params = list(named_params)
    grads = [p.grad for _, p in named_params]
    g_norm = global_norm(grads)
    if state.grad_clip > 0:
        clip_by_global_norm_(grads, g_norm, state.grad_clip)
    state.optimizer.step()
    state.scheduler.step()
    ema_update(state.ema, named_params)
    state.step += 1
    return g_norm


def _split(tree, accum: int, i: int):
    """Micro-batch ``i`` of ``accum`` of a tensor or a dict of tensors."""
    if torch.is_tensor(tree):
        return tree.chunk(accum)[i]
    return {k: v.chunk(accum)[i] for k, v in tree.items()}


def _first(batch) -> torch.Tensor:
    """A tensor of ``batch``: itself (an unconditional batch) or a value."""
    return batch if torch.is_tensor(batch) else next(iter(batch.values()))


def _global_draws(draws, sde, batch, seeds, given) -> Dict[str, torch.Tensor]:
    """The loss's ``draws`` for the global ``batch``: micro-batch ``i`` of
    ``len(seeds)`` from a generator seeded with ``seeds[i]``, what is in
    ``given`` (the injected ``noise``) taken as it is; in row order."""
    device, n = _first(batch).device, len(seeds)
    parts = [
        draws(sde, shapes_of(_split(batch, n, i)), torch.Generator(device=device).manual_seed(s), device,
              _split(given, n, i) if given else None)
        for i, s in enumerate(seeds)
    ]
    return parts[0] if n == 1 else {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def _pop_times(noise) -> Dict[str, torch.Tensor]:
    """The time draws of an injected ``noise`` dict, taken out of it: the
    continuous losses' ``t``, the discrete losses' integer ``labels``."""
    if noise is None:
        return {}
    return {k: noise.pop(k) for k in ("t", "labels") if k in noise}


def make_train_step(config, model: torch.nn.Module, data_mean=None) -> Callable:
    """``train_step(state, batch, noise=None, events=None) -> metrics``.

    ``batch`` a dict of device tensors, or one tensor for an unconditional
    recipe.  Gradient accumulation
    (``training.accumulate_grad_batches``): the batch is split into that
    many micro-batches, their gradients are summed and divided by their
    number (the JAX scan's order), and one optimizer and EMA update is
    made: the large batch's update with micro-batch activation memory.

    ``noise``: the full batch's ``t`` (a discrete recipe: ``labels``) and
    per-domain noise (a dict with key ``'t'`` or ``'labels'`` and the
    domains; unconditional: ``'x'``), split like the batch, in place of the
    draws.
    ``events``: a list to which CUDA events are appended at the start, after
    the forward and loss, after the backward and after the update (one
    micro-batch); for timing one step.
    """
    sde_fn = make_sde_for_step(config, data_mean)
    loss_fn = build_loss_fn(config, model, sde_fn(0), train=True)
    accum = int(config.training.get("accumulate_grad_batches", 1) or 1)
    params = [p for p in model.parameters() if p.requires_grad]
    names = [n for n, p in model.named_parameters() if p.requires_grad]

    def mark(events):
        if events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)

    def train_step(state: TrainState, batch, noise=None, events=None) -> Dict[str, Any]:
        rank, world = parallel.rank(), parallel.world_size()
        local = parallel.local_batch(batch, rank, world)
        B = _first(local).shape[0]
        if B % accum:
            raise ValueError(f"training.batch_size ({B}) must be divisible by accumulate_grad_batches ({accum})")
        device = _first(batch).device
        sde = sde_fn(state.step)
        seeds = [step_seed(config.seed, state.step, i) for i in range(accum)]
        noise = parallel.local_batch(_global_draws(loss_fn.draws, sde, batch, seeds, noise), rank, world)
        for p in params:
            p.grad = None
        loss = torch.zeros((), device=device)
        mark(events)
        for i in range(accum):
            mb = _split(local, accum, i) if accum > 1 else local
            mb_noise = _split(noise, accum, i) if accum > 1 else dict(noise)
            with seeded(step_seed(config.seed, state.step, i + rank * accum), device):
                loss_i = loss_fn(sde, mb, noise=mb_noise, **_pop_times(mb_noise))
                mark(events)
                loss_i.backward()
            mark(events)
            loss = loss + loss_i.detach()
        if accum > 1:
            loss = loss / accum
            torch._foreach_div_([p.grad for p in params], float(accum))
        if parallel.is_distributed():
            parallel.all_reduce_mean_([p.grad for p in params] + [loss])
        g_norm = apply_gradients(state, zip(names, params))
        mark(events)
        return {"loss": loss, "grad_norm": g_norm}

    return train_step


def make_eval_step(config, model: torch.nn.Module, data_mean=None, use_ema: bool = True) -> Callable:
    """``eval_step(state, batch, generator=None) -> {'eval_loss': tensor}``:
    the loss in eval mode (dropout off, the eval kernels where their gates
    hold), on the EMA weights, without autograd."""
    sde_fn = make_sde_for_step(config, data_mean)
    loss_fn = build_loss_fn(config, model, sde_fn(0), train=False)

    def eval_step(state: TrainState, batch, generator: Optional[torch.Generator] = None, noise=None) -> Dict[str, Any]:
        params = state.ema.params if use_ema else None
        sde = sde_fn(state.step)
        rank, world = parallel.rank(), parallel.world_size()
        sharded = parallel.is_distributed() and _first(batch).shape[0] % world == 0
        if not sharded:
            rank, world = 0, 1  # no process group, or evaluated whole on every rank
        noise = loss_fn.draws(sde, shapes_of(batch), generator, _first(batch).device, noise)
        batch, noise = parallel.local_batch(batch, rank, world), parallel.local_batch(noise, rank, world)
        with torch.no_grad():
            loss = loss_fn(sde, batch, noise=noise, params=params, **_pop_times(noise))
        if sharded:
            loss = loss.reshape(1)
            parallel.all_reduce_mean_([loss])
            loss = loss.reshape(())
        return {"eval_loss": loss}

    return eval_step
