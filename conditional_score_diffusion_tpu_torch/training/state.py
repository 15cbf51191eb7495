"""Train state: the model's parameters, the optimizer and its schedule, the
EMA and the step (JAX `training/state.py`).

`make_optimizer` is the JAX chain (optax ``clip_by_global_norm`` -> Adam or
AdamW -> linear warmup) in torch terms:

* Adam (b1 from the recipe, b2 0.999, eps 1e-8; AdamW with the recipe's
  ``weight_decay`` when it is set) is `torch.optim.Adam`/`AdamW`: the same
  update as optax's ``scale_by_adam`` up to float rounding.
* The warmup is a `LambdaLR` of ``min(k / warmup, 1)``, stepped after
  ``optimizer.step()``: update k (from 0) is taken at ``lr * k / warmup``,
  as optax evaluates its schedule at the update count before the update,
  so the first update is taken at lr 0 and changes no parameter.
* The clip is optax's, not `torch.nn.utils.clip_grad_norm_`: the gradients
  are scaled by ``max_norm / g_norm`` only when ``g_norm >= max_norm``
  (`clip_by_global_norm_`), without a host sync.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch

from ..models.ema import EMAState


@dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    ema: EMAState
    grad_clip: float


def make_optimizer(config, params) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]:
    """Adam or AdamW over ``params`` and its warmup schedule."""
    optim = config.optim
    if optim.optimizer != "Adam":
        raise NotImplementedError(f"Optimizer {optim.optimizer!r} not supported yet!")
    kw = dict(lr=optim.lr, betas=(optim.beta1, 0.999), eps=optim.eps)
    if optim.weight_decay:
        optimizer = torch.optim.AdamW(params, weight_decay=optim.weight_decay, **kw)
    else:
        optimizer = torch.optim.Adam(params, **kw)
    warmup = optim.warmup
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, (lambda k: min(k / warmup, 1.0)) if warmup > 0 else (lambda k: 1.0)
    )
    return optimizer, scheduler


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element of ``grads`` (a 0-d
    float32 tensor on their device)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def clip_by_global_norm_(grads: List[torch.Tensor], g_norm: torch.Tensor, max_norm: float) -> None:
    """optax ``clip_by_global_norm``, in place: ``g / g_norm * max_norm``
    where ``g_norm >= max_norm``, ``g`` unchanged (divided and multiplied by
    1) below it."""
    below = g_norm < max_norm
    torch._foreach_div_(grads, torch.where(below, torch.ones_like(g_norm), g_norm))
    torch._foreach_mul_(grads, torch.where(below, torch.ones_like(g_norm), torch.full_like(g_norm, max_norm)))


def create_train_state(config, model: torch.nn.Module) -> TrainState:
    """Step 0: the optimizer over ``model``'s parameters and the EMA shadow
    (decay ``model.ema_rate``) copied from them."""
    optimizer, scheduler = make_optimizer(config, model.parameters())
    return TrainState(
        step=0,
        model=model,
        optimizer=optimizer,
        scheduler=scheduler,
        ema=EMAState.create(model.named_parameters(), decay=config.model.ema_rate),
        grad_clip=float(config.optim.grad_clip),
    )
