"""Build the SDE of a recipe (JAX `sde/factory.py`): VP, sub-VP, and the VE
family (one VE SDE, or the multi-speed dict of a conditional recipe)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from .ve import VESDE
from .vp import VPSDE, subVPSDE

SDELike = Union[VESDE, VPSDE, subVPSDE, Dict[str, VESDE]]


def is_multispeed(sde) -> bool:
    """True for a multi-speed (dict) SDE."""
    return isinstance(sde, dict)


def conditioning_approach(config) -> Optional[str]:
    return config.training.get("conditioning_approach")


def is_conditional_config(config) -> bool:
    """A recipe drives a conditional (dict-SDE) model if it names a
    conditional approach or a conditional training module."""
    if conditioning_approach(config) is not None:
        return True
    task = config.training.get("lightning_module", "base")
    return "conditional" in task and not task.startswith("haar_multiscale")


def build_sde(
    config,
    data_mean: Optional[torch.Tensor] = None,
    sigma_min_y: Optional[float] = None,
    sigma_max_y: Optional[float] = None,
) -> Tuple[SDELike, float]:
    """Return ``(sde, sampling_eps)`` for a recipe.

    ``sigma_min_y`` / ``sigma_max_y`` override the recipe's values.
    """
    name = config.training.sde.lower()
    model = config.model
    if name == "vpsde":
        return VPSDE(beta_min=model.beta_min, beta_max=model.beta_max, N=model.num_scales), 1e-3
    if name == "subvpsde":
        return subVPSDE(beta_min=model.beta_min, beta_max=model.beta_max, N=model.num_scales), 1e-3
    if name != "vesde":
        raise NotImplementedError(f"SDE {config.training.sde!r} unknown.")

    if not is_conditional_config(config):
        sde = VESDE(
            sigma_min=model.sigma_min,
            sigma_max=model.sigma_max,
            data_mean=data_mean,
            N=model.num_scales,
        )
        return sde, 1e-5

    sde_x = VESDE(
        sigma_min=model.sigma_min_x,
        sigma_max=model.sigma_max_x,
        data_mean=data_mean,
        N=model.num_scales,
    )
    if conditioning_approach(config) == "sr3":
        return sde_x, 1e-5

    smin_y = sigma_min_y if sigma_min_y is not None else model.sigma_min_y
    smax_y = sigma_max_y if sigma_max_y is not None else model.sigma_max_y
    sde_y = VESDE(sigma_min=smin_y, sigma_max=smax_y, N=model.num_scales)
    return {"x": sde_x, "y": sde_y}, 1e-5
