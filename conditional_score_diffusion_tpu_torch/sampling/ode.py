"""Probability-flow ODE sampler (JAX `sampling/ode.py`): the reverse ODE
integrated from the prior at T to eps by the dopri5 solver of
`sampling/odeint.py`, then an optional reverse-diffusion denoise step.

Draws come from one noise source in the JAX order of use: the prior (when no
``z`` is given), then the denoise step's draw (its ``x_mean`` is kept, so
the draw does not reach the result).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from .odeint import odeint
from .pc import _as_noise
from .predictors import reverse_diffusion


def get_ode_sampler(
    sde,
    shape: Sequence[int],
    denoise: bool = False,
    rtol: float = 1e-5,
    atol: float = 1e-5,
    eps: float = 1e-3,
) -> Callable:
    """Returns ``ode_sampler(noise, score_fn, z=None) -> (samples, info)``;
    ``noise`` is a `torch.Generator` or a noise source, ``z`` a prior draw
    to start from.  ``info`` is ``{"nfe": -1}``, as JAX reports it."""

    def ode_sampler(noise, score_fn, z=None):
        noise = _as_noise(noise)
        x0 = sde.prior_sampling(noise, tuple(shape)).float() if z is None else z
        rsde = sde.reverse(score_fn, probability_flow=True)

        def dynamics(x, s):
            # integrate s: 0 -> T - eps with t = T - s, clamped to the domain:
            # the first-step heuristic can probe outside it
            t = torch.clamp(sde.T - s, eps, sde.T)
            drift, _ = rsde.sde(x, t.expand(x.shape[0]))
            return -drift

        ts = torch.tensor([0.0, sde.T - eps], dtype=x0.dtype, device=x0.device)
        xs, _ = odeint(dynamics, x0, ts, rtol=rtol, atol=atol)
        x = xs[-1]
        if denoise:
            vec_eps = torch.full((x.shape[0],), eps, dtype=x.dtype, device=x.device)
            _, x = reverse_diffusion(noise, x, vec_eps, sde=sde, score_fn=score_fn)
        return x, {"nfe": -1}

    return ode_sampler
