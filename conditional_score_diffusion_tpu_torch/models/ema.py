"""Exponential moving average of the parameters, as train-state data
(JAX `models/ema.py`).

The shadow parameters are a state of their own (a dict by parameter name,
copies that never alias the model's), checkpointed with the rest of the
train state.  :func:`ema_update` makes one step with the warmup decay
``min(decay, (1 + n) / (10 + n))``, ``n = num_updates + 1``, computed in
float32 as JAX computes it, and ``s -= (1 - decay) * (s - p)`` over every
parameter with `torch._foreach_*` (three launches for the whole model, no
host sync).  Unlike the pure JAX function it updates the state in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable

import numpy as np
import torch


@dataclass
class EMAState:
    decay: float
    num_updates: int
    params: Dict[str, torch.Tensor]

    @classmethod
    def create(cls, named_params: Iterable, decay: float) -> "EMAState":
        """Shadow copies of ``named_params`` (``model.named_parameters()``)."""
        return cls(decay=float(decay), num_updates=0, params={n: p.detach().clone() for n, p in named_params})


def warmup_decay(decay: float, num_updates: int) -> np.float32:
    """The decay of update number ``num_updates + 1``, in float32."""
    n = np.float32(num_updates + 1)
    return min(np.float32(decay), (np.float32(1.0) + n) / (np.float32(10.0) + n))


def ema_update(ema: EMAState, named_params: Iterable) -> None:
    """One EMA step towards ``named_params`` (the names of ``ema.params``)."""
    one_minus = float(np.float32(1.0) - warmup_decay(ema.decay, ema.num_updates))
    params = dict(named_params)
    shadow = list(ema.params.values())
    diff = torch._foreach_sub(shadow, [params[n].detach() for n in ema.params])
    torch._foreach_mul_(diff, one_minus)
    torch._foreach_sub_(shadow, diff)
    ema.num_updates += 1
