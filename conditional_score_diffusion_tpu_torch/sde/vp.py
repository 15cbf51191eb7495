"""Variance-preserving (DDPM) and sub-VP SDEs (JAX `sde/vp.py`), on torch
tensors.

The DDPM ladders (``discrete_betas``, ``alphas``, ``alphas_cumprod`` and
their roots) are methods that take a device, as `VESDE.discrete_sigmas`
does, and are built once per device.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from .base import ReverseSDE, batch_mul


def _prior_logp(z: torch.Tensor) -> torch.Tensor:
    """Standard normal log-density of each sample of ``z``."""
    dims = math.prod(z.shape[1:])
    return -dims / 2.0 * math.log(2 * math.pi) - torch.sum(z**2, dim=tuple(range(1, z.ndim))) / 2.0


class _BetaLinear:
    """beta(t) = beta_0 + t (beta_1 - beta_0) on [0, T = 1]."""

    def __init__(self, beta_min: float = 0.1, beta_max: float = 20.0, N: int = 1000):
        self.beta_0 = float(beta_min)
        self.beta_1 = float(beta_max)
        self.N = N

    @property
    def T(self) -> float:
        return 1.0

    def _beta(self, t):
        return self.beta_0 + t * (self.beta_1 - self.beta_0)

    def _log_mean_coeff(self, t):
        return -0.25 * t**2 * (self.beta_1 - self.beta_0) - 0.5 * t * self.beta_0

    def prior_sampling(self, noise: Callable, shape: Sequence[int]) -> torch.Tensor:
        """A prior draw; ``noise(shape)`` gives standard normal values."""
        return noise(tuple(shape))

    def prior_logp(self, z: torch.Tensor) -> torch.Tensor:
        return _prior_logp(z)

    def reverse(self, score_fn, probability_flow: bool = False) -> ReverseSDE:
        return ReverseSDE(self, score_fn, probability_flow)


class VPSDE(_BetaLinear):
    """dx = -1/2 beta(t) x dt + sqrt(beta(t)) dW."""

    def __init__(self, beta_min: float = 0.1, beta_max: float = 20.0, N: int = 1000):
        super().__init__(beta_min, beta_max, N)
        self._ladders = {}  # device -> (betas, alphas, alphas_cumprod)

    def _ladder(self, device):
        key = torch.device(device)
        if key not in self._ladders:
            betas = torch.linspace(self.beta_0 / self.N, self.beta_1 / self.N, self.N, dtype=torch.float32)
            alphas = 1.0 - betas
            cumprod = torch.cumprod(alphas, dim=0)
            self._ladders[key] = tuple(v.to(key) for v in (betas, alphas, cumprod))
        return self._ladders[key]

    def discrete_betas(self, device) -> torch.Tensor:
        return self._ladder(device)[0]

    def alphas(self, device) -> torch.Tensor:
        return self._ladder(device)[1]

    def alphas_cumprod(self, device) -> torch.Tensor:
        return self._ladder(device)[2]

    def sqrt_alphas_cumprod(self, device) -> torch.Tensor:
        return torch.sqrt(self.alphas_cumprod(device))

    def sqrt_1m_alphas_cumprod(self, device) -> torch.Tensor:
        return torch.sqrt(1.0 - self.alphas_cumprod(device))

    def sde(self, x, t):
        beta_t = self._beta(t)
        return batch_mul(-0.5 * beta_t, x), torch.sqrt(beta_t)

    def marginal_prob(self, x: Optional[torch.Tensor], t):
        """(mean, std) of p(x_t | x_0); the mean is None for ``x`` None (the
        score wrappers want the std alone)."""
        lmc = self._log_mean_coeff(t)
        mean = None if x is None else batch_mul(torch.exp(lmc), x)
        return mean, torch.sqrt(1.0 - torch.exp(2.0 * lmc))

    def discretize(self, x, t):
        """DDPM discretization: ``(f, G)``."""
        timestep = (t * (self.N - 1) / self.T).to(torch.int64)
        beta = self.discrete_betas(t.device)[timestep]
        alpha = self.alphas(t.device)[timestep]
        f = batch_mul(torch.sqrt(alpha), x) - x
        return f, torch.sqrt(beta)


class subVPSDE(_BetaLinear):
    """Sub-VP SDE: the VP drift, diffusion discounted by 1 - exp(-2 int beta)."""

    def sde(self, x, t):
        beta_t = self._beta(t)
        discount = 1.0 - torch.exp(-2.0 * self.beta_0 * t - (self.beta_1 - self.beta_0) * t**2)
        return batch_mul(-0.5 * beta_t, x), torch.sqrt(beta_t * discount)

    def marginal_prob(self, x: Optional[torch.Tensor], t):
        """(mean, std); the std is 1 - exp(2 lmc), not its root, as in JAX
        and the reference implementation."""
        lmc = self._log_mean_coeff(t)
        mean = None if x is None else batch_mul(torch.exp(lmc), x)
        return mean, 1.0 - torch.exp(2.0 * lmc)

    def discretize(self, x, t):
        dt = 1.0 / self.N
        drift, diffusion = self.sde(x, t)
        return drift * dt, diffusion * math.sqrt(dt)
