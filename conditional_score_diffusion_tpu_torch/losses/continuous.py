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
torch.Generator cannot agree.  ``loss_fn.draws(sde, shapes, generator,
device, given=None)`` is the one place that order is written: the loss
calls it for its own batch, and the train step calls it for the global
batch of a data-parallel step (`training/steps.py`).  Dropout, in train
mode, draws from torch's default generator of the device
(`training/steps.py` seeds it per step).
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


def shapes_of(batch):
    """The shape of a tensor batch, or a dict of shapes by key."""
    return batch.shape if torch.is_tensor(batch) else {k: v.shape for k, v in batch.items()}


def given_draws(key: str, times, noise) -> Dict[str, torch.Tensor]:
    """The injected draws of a loss call as one dict: ``noise`` and, where
    given, the times under ``key`` (``'t'`` or ``'labels'``)."""
    given = dict(noise or {})
    if times is not None:
        given[key] = times
    return given


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

    def draws(sde, shapes, generator, device, given=None) -> Dict[str, torch.Tensor]:
        """The loss's random inputs for a batch of ``shapes`` (a shape, or a
        dict of shapes by key): ``{'t': t, <domain>: noise}``, each taken
        from ``given`` where it is there and otherwise drawn from
        ``generator``, in the JAX order (t, then the sorted domains)."""
        given = given or {}
        if not conditional:
            keys, T, shapes = ["x"], sde.T, {"x": shapes}
        elif is_multispeed(sde):
            keys = sorted(k for k in shapes if k in sde)
            T = sde[keys[0]].T
        else:
            keys, T = ["x"], sde.T
        out = {"t": given["t"] if "t" in given else _uniform_t(shapes[keys[0]][0], T, eps, generator, device)}
        for k in keys:
            out[k] = given[k] if k in given else torch.randn(tuple(shapes[k]), generator=generator, device=device)
        return out

    def loss_fn(
        sde,
        batch: Union[torch.Tensor, Mapping[str, torch.Tensor]],
        generator: Optional[torch.Generator] = None,
        t: Optional[torch.Tensor] = None,
        noise: Optional[Mapping[str, torch.Tensor]] = None,
        params: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> torch.Tensor:
        if conditional and is_multispeed(sde) and not likelihood_weighting:
            raise ValueError("multi-speed diffusion supports only likelihood weighting")
        device = batch.device if torch.is_tensor(batch) else next(iter(batch.values())).device
        noise = draws(sde, shapes_of(batch), generator, device, given_draws("t", t, noise))
        t = noise.pop("t")
        if not conditional:
            return single_sde_loss(sde, batch, None, t, noise["x"], params)
        if not is_multispeed(sde):  # SR3/CDE: x is perturbed, y enters the network clean.
            return single_sde_loss(sde, batch["x"], batch["y"], t, noise["x"], params)
        stds: Dict[str, torch.Tensor] = {}
        perturbed: Dict[str, torch.Tensor] = {}
        for k in noise:
            mean, std = sde[k].marginal_prob(batch[k], t)
            stds[k] = std
            perturbed[k] = mean + batch_mul(std, noise[k])
        score = score_fn(sde, params)(perturbed, t)
        parts = []
        for k in noise:
            g2 = sde[k].sde(batch[k], t)[1] ** 2
            err = torch.square(score[k] + batch_mul(1.0 / stds[k], noise[k]))
            parts.append(_flat(batch_mul(g2, err)))
        return _reduce(torch.cat(parts, dim=-1), reduce_mean).mean()

    loss_fn.draws = draws
    return loss_fn
