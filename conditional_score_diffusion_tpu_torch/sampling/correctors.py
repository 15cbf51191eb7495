"""Corrector: SNR-adaptive Langevin MCMC (JAX `sampling/correctors.py`).

``update(noise, x, t, *, sde, score_fn, snr, n_steps, y=None) -> (x, x_mean)``.
"""

from __future__ import annotations

import torch

from .. import registry
from ..sde import batch_mul

register_corrector = registry.correctors.register
get_corrector = registry.correctors.get


@register_corrector(name="langevin")
def langevin(noise, x, t, *, sde, score_fn, snr, n_steps, y=None):
    """The VE step (alpha = 1); each of the ``n_steps`` draws fresh noise."""
    alpha = torch.ones_like(t)
    x_mean = x
    for _ in range(n_steps):
        grad = score_fn(x, t) if y is None else score_fn(x, y, t)
        z = noise(x.shape)
        grad_norm = torch.linalg.vector_norm(grad.reshape(grad.shape[0], -1), dim=-1).mean()
        noise_norm = torch.linalg.vector_norm(z.reshape(z.shape[0], -1), dim=-1).mean()
        step_size = (snr * noise_norm / grad_norm) ** 2 * 2 * alpha
        x_mean = x + batch_mul(step_size, grad)
        x = x_mean + batch_mul(torch.sqrt(step_size * 2), z)
    return x, x_mean


registry.correctors.register(langevin, name="conditional_langevin")
