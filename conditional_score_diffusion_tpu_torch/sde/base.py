"""Broadcasting helper and the reverse-time SDE (JAX `sde/base.py`)."""

from __future__ import annotations

from typing import Callable, Optional

import torch


def batch_mul(a, x: torch.Tensor) -> torch.Tensor:
    """Multiply a per-batch scalar (shape ``[B]``, or a 0-d value) into
    ``x`` (shape ``[B, ...]``)."""
    if not torch.is_tensor(a) or a.ndim == 0:
        return a * x
    return a.reshape(a.shape + (1,) * (x.ndim - a.ndim)) * x


class ReverseSDE:
    """Reverse-time SDE for a forward SDE and a score function.

    ``score_fn`` takes ``(x, t)``, or ``(x, y, t)`` when ``y`` is passed.
    """

    def __init__(self, sde, score_fn: Callable, probability_flow: bool = False):
        self.fwd = sde
        self.score_fn = score_fn
        self.probability_flow = probability_flow
        self.N = sde.N
        self.T = sde.T

    def _score(self, x, t, y=None):
        if y is None:
            return self.score_fn(x, t)
        return self.score_fn(x, y, t)

    def sde(self, x, t, y: Optional[torch.Tensor] = None):
        """Drift and diffusion of the reverse SDE (or probability-flow ODE)."""
        drift, diffusion = self.fwd.sde(x, t)
        score = self._score(x, t, y)
        factor = 0.5 if self.probability_flow else 1.0
        drift = drift - batch_mul(diffusion**2, score) * factor
        diffusion = torch.zeros_like(diffusion) if self.probability_flow else diffusion
        return drift, diffusion

    def discretize(self, x, t, y: Optional[torch.Tensor] = None):
        """Discretized reverse update terms ``(rev_f, rev_G)``."""
        f, G = self.fwd.discretize(x, t)
        score = self._score(x, t, y)
        factor = 0.5 if self.probability_flow else 1.0
        rev_f = f - batch_mul(G**2, score) * factor
        rev_G = torch.zeros_like(G) if self.probability_flow else G
        return rev_f, rev_G
