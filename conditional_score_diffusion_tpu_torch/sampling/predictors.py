"""Predictors: one reverse-SDE step each (JAX `sampling/predictors.py`):
``euler_maruyama``, ``reverse_diffusion``, ``ancestral_sampling`` (VE and
VP) and ``none``.

``update(noise, x, t, *, sde, score_fn, probability_flow=False, y=None)
-> (x, x_mean)``, where ``noise(shape)`` returns standard normal values on
the device of ``x``; each predictor but ``none`` draws once.  The
``conditional_*`` registry names alias the same functions; ``score_fn``
takes ``(x, y, t)`` when ``y`` is passed, else ``(x, t)``.
"""

from __future__ import annotations

import math

import torch

from .. import registry
from ..sde import VESDE, VPSDE, batch_mul

register_predictor = registry.predictors.register
get_predictor = registry.predictors.get


def timestep_index(sde, t: torch.Tensor) -> torch.Tensor:
    """The discrete step of ``t``, truncated as JAX's ``astype(int32)``."""
    return (t * (sde.N - 1) / sde.T).to(torch.int64)


@register_predictor(name="euler_maruyama")
def euler_maruyama(noise, x, t, *, sde, score_fn, probability_flow=False, y=None):
    rsde = sde.reverse(score_fn, probability_flow)
    dt = -1.0 / rsde.N
    z = noise(x.shape)
    drift, diffusion = rsde.sde(x, t, y)
    x_mean = x + drift * dt
    x = x_mean + batch_mul(diffusion, math.sqrt(-dt) * z)
    return x, x_mean


@register_predictor(name="reverse_diffusion")
def reverse_diffusion(noise, x, t, *, sde, score_fn, probability_flow=False, y=None):
    rsde = sde.reverse(score_fn, probability_flow)
    f, G = rsde.discretize(x, t, y)
    z = noise(x.shape)
    x_mean = x - f
    x = x_mean + batch_mul(G, z)
    return x, x_mean


@register_predictor(name="ancestral_sampling")
def ancestral_sampling(noise, x, t, *, sde, score_fn, probability_flow=False, y=None):
    """The ancestral step of the SDE's discrete ladder (VE: SMLD, VP: DDPM)."""
    if probability_flow:
        raise ValueError("probability flow is not supported by ancestral sampling")
    score = score_fn(x, t) if y is None else score_fn(x, y, t)
    timestep = timestep_index(sde, t)
    z = noise(x.shape)
    if isinstance(sde, VESDE):
        sigmas = sde.discrete_sigmas(t.device)
        sigma = sigmas[timestep]
        adjacent = torch.where(timestep == 0, torch.zeros_like(sigma), sigmas[torch.clamp(timestep - 1, min=0)])
        x_mean = x + batch_mul(sigma**2 - adjacent**2, score)
        std = torch.sqrt(adjacent**2 * (sigma**2 - adjacent**2) / sigma**2)
        return x_mean + batch_mul(std, z), x_mean
    if isinstance(sde, VPSDE):
        beta = sde.discrete_betas(t.device)[timestep]
        x_mean = batch_mul(1.0 / torch.sqrt(1.0 - beta), x + batch_mul(beta, score))
        return x_mean + batch_mul(torch.sqrt(beta), z), x_mean
    raise NotImplementedError(f"ancestral sampling: SDE {type(sde).__name__} unsupported")


@register_predictor(name="none")
def none_predictor(noise, x, t, *, sde=None, score_fn=None, probability_flow=False, y=None):
    return x, x


for _fn, _name in ((euler_maruyama, "euler_maruyama"), (reverse_diffusion, "reverse_diffusion"),
                   (ancestral_sampling, "ancestral_sampling"), (none_predictor, "none")):
    register_predictor(_fn, name=f"conditional_{_name}")
