"""Continuous denoising-score-matching losses (JAX `losses/continuous.py`).

``loss_fn(sde, batch, generator=None, t=None, noise=None, params=None)``
returns the scalar loss of one batch:

* the multi-speed branch (a dict SDE and a conditional model): every domain
  of the SDE that the batch carries (keys sorted; other keys such as an
  inpainting ``mask`` are ignored) is diffused at one shared time ``t``,
  and the likelihood-weighted errors of all domains are concatenated per
  sample before the reduction; only likelihood weighting is supported, as
  in JAX;
* the SR3 branch (a single SDE and a conditional model): x is diffused, y
  enters the network clean;
* the unconditional branch (``batch`` a tensor, the data): it is diffused
  and the unconditional score of it held to the noise, with or without
  likelihood weighting.

Randomness: ``t`` is uniform in [eps, T) and the noise standard normal, both
drawn from ``generator`` (a `torch.Generator` on the batch's device) in the
JAX order (t, then one draw per sorted domain; SR3 and unconditional: t,
then z).  ``t`` and ``noise`` (a dict by domain; SR3 and unconditional:
``{'x': z}``) may be given instead, as the
parity tests do with the JAX key chain's draws; jax.random and
torch.Generator cannot agree.  Dropout, in train mode, draws from torch's
default generator of the device (`training/steps.py` seeds it per step).
``params``: evaluate the model with these tensors in place of its own
parameters (the EMA weights of an eval loss).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Union

import torch

from ..models.wrappers import get_score_fn
from ..sde import batch_mul, is_multispeed


def _reduce(losses_flat: torch.Tensor, reduce_mean: bool) -> torch.Tensor:
    """Per-sample reduction over the flattened data dims."""
    if reduce_mean:
        return losses_flat.mean(dim=-1)
    return 0.5 * losses_flat.sum(dim=-1)


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def _uniform_t(B: int, T: float, eps: float, generator, device) -> torch.Tensor:
    """``U[eps, T)`` per sample, as `jax.random.uniform(minval, maxval)`."""
    return eps + (T - eps) * torch.rand(B, generator=generator, device=device)


def get_general_sde_loss_fn(
    model: torch.nn.Module,
    conditional: bool = False,
    train: bool = True,
    reduce_mean: bool = True,
    likelihood_weighting: bool = True,
    eps: float = 1e-5,
) -> Callable:
    """The continuous DSM loss of ``model`` (see the module docstring)."""

    def score_fn(sde, params):
        return get_score_fn(sde, model, conditional=conditional, train=train, continuous=True, params=params)

    def single_sde_loss(sde, x, y, t, z, params):
        """SR3 (x diffused, ``y`` clean) or, with ``y`` None, unconditional."""
        mean, std = sde.marginal_prob(x, t)
        perturbed = mean + batch_mul(std, z)
        score = score_fn(sde, params)(perturbed if y is None else {"x": perturbed, "y": y}, t)
        if likelihood_weighting:
            g2 = sde.sde(x, t)[1] ** 2
            per_sample = _reduce(_flat(torch.square(score + batch_mul(1.0 / std, z))), reduce_mean) * g2
        else:
            per_sample = _reduce(_flat(torch.square(batch_mul(std, score) + z)), reduce_mean)
        return per_sample.mean()

    def loss_fn(
        sde,
        batch: Union[torch.Tensor, Mapping[str, torch.Tensor]],
        generator: Optional[torch.Generator] = None,
        t: Optional[torch.Tensor] = None,
        noise: Optional[Mapping[str, torch.Tensor]] = None,
        params: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> torch.Tensor:
        noise = dict(noise or {})
        if not conditional:
            x, y = batch, None
        elif is_multispeed(sde):
            if not likelihood_weighting:
                raise ValueError("multi-speed diffusion supports only likelihood weighting")
            keys = sorted(k for k in batch if k in sde)
            first = batch[keys[0]]
            if t is None:
                t = _uniform_t(first.shape[0], sde[keys[0]].T, eps, generator, first.device)
            stds: Dict[str, torch.Tensor] = {}
            perturbed: Dict[str, torch.Tensor] = {}
            for k in keys:
                if k not in noise:
                    noise[k] = torch.randn(batch[k].shape, generator=generator, device=batch[k].device)
                mean, std = sde[k].marginal_prob(batch[k], t)
                stds[k] = std
                perturbed[k] = mean + batch_mul(std, noise[k])
            score = score_fn(sde, params)(perturbed, t)
            parts = []
            for k in keys:
                g2 = sde[k].sde(batch[k], t)[1] ** 2
                err = torch.square(score[k] + batch_mul(1.0 / stds[k], noise[k]))
                parts.append(_flat(batch_mul(g2, err)))
            return _reduce(torch.cat(parts, dim=-1), reduce_mean).mean()
        else:  # SR3/CDE: x is perturbed, y enters the network clean.
            x, y = batch["x"], batch["y"]
        if t is None:
            t = _uniform_t(x.shape[0], sde.T, eps, generator, x.device)
        z = noise["x"] if "x" in noise else torch.randn(x.shape, generator=generator, device=x.device)
        return single_sde_loss(sde, x, y, t, z, params)

    return loss_fn
