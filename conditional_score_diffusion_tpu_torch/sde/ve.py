"""Variance-exploding (SMLD) SDE (JAX `sde/ve.py`), on torch tensors.

Every method computes on the device of its tensor arguments.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from .base import ReverseSDE, batch_mul


class VESDE:
    """dx = sigma(t) * sqrt(2 log(sigma_max/sigma_min)) dW, sigma geometric."""

    def __init__(
        self,
        sigma_min: float = 0.01,
        sigma_max: float = 50.0,
        data_mean: Optional[torch.Tensor] = None,
        N: int = 1000,
    ):
        self.sigma_min = float(sigma_min)
        self.sigma_max = float(sigma_max)
        self.data_mean = data_mean
        self.N = N
        self._sigmas = {}  # device -> discrete_sigmas, built once per device

    @property
    def T(self) -> float:
        return 1.0

    def _sigma(self, t: torch.Tensor) -> torch.Tensor:
        return self.sigma_min * (self.sigma_max / self.sigma_min) ** t

    def discrete_sigmas(self, device) -> torch.Tensor:
        """Geometric sigma ladder, ascending, as float32 on ``device``."""
        key = torch.device(device)
        if key not in self._sigmas:
            lo = torch.log(torch.tensor(self.sigma_min, dtype=torch.float32))
            hi = torch.log(torch.tensor(self.sigma_max, dtype=torch.float32))
            self._sigmas[key] = torch.exp(torch.linspace(lo, hi, self.N)).to(key)
        return self._sigmas[key]

    def sde(self, x, t):
        sigma = self._sigma(t)
        drift = torch.zeros_like(x)
        diffusion = sigma * math.sqrt(2.0 * (math.log(self.sigma_max) - math.log(self.sigma_min)))
        return drift, diffusion

    def marginal_prob(self, x, t):
        """Perturbation-kernel parameters of p(x_t | x_0): (mean, std)."""
        return x, self._sigma(t)

    def compute_backward_kernel(self, x0, x_tplustau, t, tau):
        """Parameters of p(x_t | x_0, x_{t+tau}): (mean, std)."""
        s_t2 = self._sigma(t) ** 2
        s_tt2 = self._sigma(t + tau) ** 2
        std = torch.sqrt(s_t2 * (s_tt2 - s_t2) / s_tt2)
        w0 = (s_tt2 - s_t2) / s_tt2
        w1 = s_t2 / s_tt2
        mean = batch_mul(w0, x0) + batch_mul(w1, x_tplustau)
        return mean, std

    def prior_sampling(self, noise: Callable, shape: Sequence[int]) -> torch.Tensor:
        """A prior draw; ``noise(shape)`` gives standard normal values."""
        z = noise(tuple(shape)) * self.sigma_max
        if self.data_mean is not None:
            z = z + self.data_mean.expand(shape)
        return z

    def prior_logp(self, z: torch.Tensor) -> torch.Tensor:
        """Log-density of each sample of ``z`` under the prior N(0, sigma_max^2 I)."""
        dims = math.prod(z.shape[1:])
        return (
            -dims / 2.0 * math.log(2 * math.pi * self.sigma_max**2)
            - torch.sum(z**2, dim=tuple(range(1, z.ndim))) / (2 * self.sigma_max**2)
        )

    def discretize(self, x, t):
        """SMLD (NCSN) discretization: ``(f, G)``."""
        timestep = (t * (self.N - 1) / self.T).to(torch.int64)
        sigmas = self.discrete_sigmas(t.device)
        sigma = sigmas[timestep]
        adjacent = torch.where(
            timestep == 0, torch.zeros_like(sigma), sigmas[torch.clamp(timestep - 1, min=0)]
        )
        f = torch.zeros_like(x)
        G = torch.sqrt(sigma**2 - adjacent**2)
        return f, G

    def reverse(self, score_fn, probability_flow: bool = False) -> ReverseSDE:
        return ReverseSDE(self, score_fn, probability_flow)
