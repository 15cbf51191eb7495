"""Correctors: score-based MCMC steps (JAX `sampling/correctors.py`):
SNR-adaptive Langevin (``langevin``), annealed Langevin dynamics (``ald``)
and ``none``.

``update(noise, x, t, *, sde, score_fn, snr, n_steps, y=None) -> (x, x_mean)``;
``langevin`` and ``ald`` draw fresh noise on each of their ``n_steps``.
The step size carries alpha: 1 under VE, the DDPM ``alphas[timestep]``
under VP.  The ``conditional_*`` registry names alias the same functions.
The Langevin step size takes the batch's mean score and noise norms
(`parallel.batch_mean`: over every rank's rows in a sharded sampler).
"""

from __future__ import annotations

import torch

from .. import registry
from ..parallel import batch_mean
from ..sde import VPSDE, batch_mul
from .predictors import timestep_index

register_corrector = registry.correctors.register
get_corrector = registry.correctors.get


def _alpha(sde, t):
    if isinstance(sde, VPSDE):
        return sde.alphas(t.device)[timestep_index(sde, t)]
    return torch.ones_like(t)


@register_corrector(name="langevin")
def langevin(noise, x, t, *, sde, score_fn, snr, n_steps, y=None):
    alpha = _alpha(sde, t)
    x_mean = x
    for _ in range(n_steps):
        grad = score_fn(x, t) if y is None else score_fn(x, y, t)
        z = noise(x.shape)
        grad_norm = batch_mean(torch.linalg.vector_norm(grad.reshape(grad.shape[0], -1), dim=-1))
        noise_norm = batch_mean(torch.linalg.vector_norm(z.reshape(z.shape[0], -1), dim=-1))
        step_size = (snr * noise_norm / grad_norm) ** 2 * 2 * alpha
        x_mean = x + batch_mul(step_size, grad)
        x = x_mean + batch_mul(torch.sqrt(step_size * 2), z)
    return x, x_mean


@register_corrector(name="ald")
def annealed_langevin(noise, x, t, *, sde, score_fn, snr, n_steps, y=None):
    """The original NCSN annealed Langevin dynamics: step (snr * std)^2 * 2 * alpha."""
    alpha = _alpha(sde, t)
    std = sde.marginal_prob(x, t)[1]
    x_mean = x
    for _ in range(n_steps):
        grad = score_fn(x, t) if y is None else score_fn(x, y, t)
        z = noise(x.shape)
        step_size = (snr * std) ** 2 * 2 * alpha
        x_mean = x + batch_mul(step_size, grad)
        x = x_mean + batch_mul(torch.sqrt(step_size * 2), z)
    return x, x_mean


@register_corrector(name="none")
def none_corrector(noise, x, t, *, sde=None, score_fn=None, snr=None, n_steps=0, y=None):
    return x, x


for _fn, _name in ((langevin, "langevin"), (annealed_langevin, "ald"), (none_corrector, "none")):
    register_corrector(_fn, name=f"conditional_{_name}")
