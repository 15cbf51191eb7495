"""The VS-CMDE decreasing-variance schedule as functions of the training
step, copied from the JAX package's `training/schedules.py`.

sigma_y anneals from ``model.sigma_max_y`` to ``model.sigma_max_y_target``
over ``model.reach_target_steps`` steps by the inverse-multiplicative
reduction ``f(x) = xk*yk*y0 / (x*(y0-yk) + xk*yk)``.  A sampler restores
sigma_y at a checkpoint's step from it (the JAX `eval/harness.py:81-87`):

    sde, eps = build_sde(config, *sigma_y_at_step(config, step))

A recipe with no ``model.reach_target_steps`` keeps sigma_y at its
``model.sigma_min_y`` / ``sigma_max_y``: the celebA Haar scales 80 and 160
name their schedule by legacy knobs (``model.reduction``,
``reach_target_in_epochs``, ``starting_transition_iterations``) that no
code reads and give no target, where JAX's schedule fails on the missing
field.
"""

from __future__ import annotations

from typing import Tuple

import torch


def reduction_fn(x, y0: float, xk: float, yk: float) -> torch.Tensor:
    """Inverse-multiplicative anneal from y0 (at x = 0) to yk (at x = xk),
    in float32 as the JAX function computes it."""
    x = torch.as_tensor(x, dtype=torch.float32)
    # a float32 numerator: a Python float over a tensor would multiply by
    # the reciprocal, which rounds differently
    return torch.tensor(xk * yk * y0, dtype=torch.float32) / (x * (y0 - yk) + xk * yk)


def sigma_y_at_step(config, step) -> Tuple[float, float]:
    """``(sigma_min_y, sigma_max_y)`` of a VS-CMDE recipe at ``step``."""
    m = config.model
    if "reach_target_steps" not in m:
        return float(m.sigma_min_y), float(m.sigma_max_y)
    smax = reduction_fn(step, m.sigma_max_y, m.reach_target_steps, m.sigma_max_y_target)
    smin = reduction_fn(step, m.sigma_min_y, m.reach_target_steps, m.sigma_min_y_target)
    return float(smin), float(smax)


def is_decreasing_variance(config) -> bool:
    """True for VS-CMDE (``lightning_module = '*conditional_decreasing_variance'``)."""
    return "decreasing_variance" in config.training.get("lightning_module", "base")
