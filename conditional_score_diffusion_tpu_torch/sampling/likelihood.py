"""Exact likelihood (bits/dim) through the probability-flow ODE (JAX
`sampling/likelihood.py`).

The state (x, log-density change) integrates from eps to T with the dopri5
solver of `sampling/odeint.py`, raveled together as JAX ravels it, so both
share one step size.  The divergence of the drift is Hutchinson-Skilling's
estimate eps^T J eps with a Rademacher or Gaussian probe.  JAX takes J eps
by forward mode (`jax.jvp`); here eps^T J comes by reverse mode, one
`torch.autograd.grad` of (drift . eps) with respect to x, which is the same
scalar per sample.  Forward mode is not used: the kernels' ctypes calls have
no forward-mode rule.  A call that carries a gradient takes the plain
versions of the kernels on its path (`ops/upfirdn.py`, `models/layers.py`).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from .odeint import odeint
from .pc import _as_noise


def _drift_and_div(drift_fn: Callable, x, t, epsilon):
    """(drift, eps^T d drift / dx eps per sample), from one forward."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        drift = drift_fn(x, t)
        (grad,) = torch.autograd.grad(torch.sum(drift * epsilon), x)
    return drift.detach(), torch.sum(grad * epsilon, dim=tuple(range(1, x.ndim)))


def get_div_fn(drift_fn: Callable, hutchinson_type: str = "Rademacher") -> Callable:
    """``div_fn(x, t, epsilon)``: the divergence estimate of ``drift_fn(x,
    t)`` per sample (``hutchinson_type`` names the probe the caller draws)."""
    del hutchinson_type

    def div_fn(x, t, epsilon):
        return _drift_and_div(drift_fn, x, t, epsilon)[1]

    return div_fn


def get_likelihood_fn(
    sde,
    hutchinson_type: str = "Rademacher",
    rtol: float = 1e-5,
    atol: float = 1e-5,
    eps: float = 1e-5,
) -> Callable:
    """Returns ``likelihood_fn(noise, score_fn, data, epsilon=None) -> (bpd,
    z, nfe)``, with ``nfe`` -1 as JAX reports it.

    ``noise`` is a `torch.Generator` or a callable ``noise(shape)`` of
    standard normal values; a Rademacher probe is the sign of a normal
    draw.  ``epsilon`` fixes the probe.  bpd is ``-logp / ln 2 / dims +
    8``, the offset of 8 bits copied from JAX whatever the data's range.
    """
    kind = hutchinson_type.lower()
    if kind not in ("rademacher", "gaussian"):
        raise NotImplementedError(f"Hutchinson type {hutchinson_type} unknown.")

    def likelihood_fn(noise, score_fn, data, epsilon: Optional[torch.Tensor] = None):
        rsde = sde.reverse(score_fn, probability_flow=True)

        def drift_fn(x, t):
            return rsde.sde(x, t.expand(x.shape[0]))[0]

        if epsilon is None:
            epsilon = _as_noise(noise)(tuple(data.shape)).to(data.dtype)
            if kind == "rademacher":
                epsilon = torch.where(epsilon < 0, -1.0, 1.0).to(data.dtype)

        def dynamics(state, s):
            x, _ = state
            # integrate t: eps -> T, clamped to the domain
            t = torch.clamp(eps + s, eps, sde.T)
            return _drift_and_div(drift_fn, x, t, epsilon)

        init = (data, torch.zeros(data.shape[0], dtype=data.dtype, device=data.device))
        ts = torch.tensor([0.0, sde.T - eps], dtype=data.dtype, device=data.device)
        (xs, dlogps), _ = odeint(dynamics, init, ts, rtol=rtol, atol=atol)
        z, delta_logp = xs[-1], dlogps[-1]
        logp = sde.prior_logp(z) + delta_logp
        dims = math.prod(data.shape[1:])
        bpd = -logp / math.log(2) / dims + 8.0
        return bpd, z, -1

    return likelihood_fn
