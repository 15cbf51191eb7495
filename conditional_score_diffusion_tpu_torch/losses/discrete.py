"""Discrete-time losses (JAX `losses/discrete.py`): SMLD (the NCSN
denoising loss on the VE sigma ladder), the two-domain inverse-problem SMLD
on a multi-speed dict SDE, and the DDPM epsilon loss.

``loss_fn(sde, batch, generator=None, labels=None, noise=None, params=None)``
returns the scalar loss of one batch.  ``labels`` (the integer noise level
of each sample, uniform in [0, N)) and ``noise`` (standard normal: SMLD and
DDPM ``{'x': z}``; the inverse problem ``{'x': zx, 'y': zy}``) are drawn
from ``generator`` in the JAX order (labels, then the noise, x before y)
by ``loss_fn.draws`` unless given, as the parity tests give JAX's draws.
``params`` as in the continuous loss (the EMA weights of an eval loss).

The score of the SMLD losses is called at ``t = labels / (N - 1)``, which the
discrete VE wrapper rounds back to the labels; an unconditional NCSN is
therefore fed the sigma at the label and casts it to its class (floor
sigma), as in JAX (ROADMAP.md section 3, hazards).
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch

from ..models.wrappers import get_model_fn, get_score_fn
from ..sde import batch_mul
from .continuous import _flat, _reduce, given_draws, shapes_of


def _draws(levels: Callable, keys) -> Callable:
    """``draws(sde, shapes, generator, device, given=None)``: a loss's
    random inputs for a batch of ``shapes`` (a shape, or a dict of shapes by
    key), ``{'labels': ..., <key>: noise, ...}``, each taken from ``given``
    where it is there and otherwise drawn from ``generator`` in the JAX
    order (labels, then the keys)."""

    def draws(sde, shapes, generator, device, given=None):
        given = given or {}
        if not isinstance(shapes, Mapping):
            shapes = {"x": shapes}
        if "labels" in given:
            labels = given["labels"].to(device=device, dtype=torch.int64)
        else:
            labels = torch.randint(0, levels(sde), (shapes["x"][0],), generator=generator, device=device)
        out = {"labels": labels}
        for k in keys:
            out[k] = given[k] if k in given else torch.randn(tuple(shapes[k]), generator=generator, device=device)
        return out

    return draws


def _inputs(loss_fn, sde, batch, generator, labels, noise):
    """``loss_fn.draws`` for ``batch``: the labels and the noise dict."""
    device = batch.device if torch.is_tensor(batch) else batch["x"].device
    out = loss_fn.draws(sde, shapes_of(batch), generator, device, given_draws("labels", labels, noise))
    return out.pop("labels"), out


def get_smld_loss_fn(model, train: bool = True, reduce_mean: bool = False, likelihood_weighting: bool = False) -> Callable:
    """The per-label SMLD loss, weighted by sigma^2."""

    def loss_fn(vesde, batch, generator=None, labels=None, noise=None, params=None):
        labels, noise = _inputs(loss_fn, vesde, batch, generator, labels, noise)
        sigmas = vesde.discrete_sigmas(batch.device)[labels]
        perturbation = batch_mul(sigmas, noise["x"])
        score_fn = get_score_fn(vesde, model, conditional=False, train=train, continuous=False, params=params)
        score = score_fn(batch + perturbation, labels / (vesde.N - 1))
        losses = torch.square(score + batch_mul(1.0 / sigmas**2, perturbation))
        if likelihood_weighting:
            per_sample = _reduce(_flat(batch_mul(sigmas**2, losses)), reduce_mean)
        else:
            per_sample = _reduce(_flat(losses), reduce_mean) * sigmas**2
        return per_sample.mean()

    loss_fn.draws = _draws(lambda sde: sde.N, ("x",))
    return loss_fn


def get_inverse_problem_smld_loss_fn(
    model, train: bool = True, reduce_mean: bool = False, likelihood_weighting: bool = True
) -> Callable:
    """SMLD on both domains of a multi-speed SDE at one shared label; each
    domain perturbed on its own ladder."""

    def loss_fn(sde, batch, generator=None, labels=None, noise=None, params=None):
        x, y = batch["x"], batch["y"]
        labels, noise = _inputs(loss_fn, sde, batch, generator, labels, noise)
        sigmas_x = sde["x"].discrete_sigmas(x.device)[labels]
        sigmas_y = sde["y"].discrete_sigmas(x.device)[labels]
        noise_x = batch_mul(sigmas_x, noise["x"])
        noise_y = batch_mul(sigmas_y, noise["y"])
        score_fn = get_score_fn(sde, model, conditional=True, train=train, continuous=False, params=params)
        score = score_fn({"x": x + noise_x, "y": y + noise_y}, labels / (sde["x"].N - 1))
        lx = torch.square(score["x"] + batch_mul(1.0 / sigmas_x**2, noise_x))
        ly = torch.square(score["y"] + batch_mul(1.0 / sigmas_y**2, noise_y))
        if likelihood_weighting:
            lx, ly = batch_mul(sigmas_x**2, lx), batch_mul(sigmas_y**2, ly)
            return _reduce(torch.cat([_flat(lx), _flat(ly)], dim=-1), reduce_mean).mean()
        smld_weight = (sigmas_x**2 * sigmas_y**2) / (sigmas_x**2 + sigmas_y**2)
        return (_reduce(torch.cat([_flat(lx), _flat(ly)], dim=-1), reduce_mean) * smld_weight).mean()

    loss_fn.draws = _draws(lambda sde: sde["x"].N, ("x", "y"))
    return loss_fn


def get_ddpm_loss_fn(model, train: bool = True, reduce_mean: bool = True) -> Callable:
    """The DDPM epsilon loss: the network at the integer label predicts the
    noise of the DDPM forward process."""

    def loss_fn(vpsde, batch, generator=None, labels=None, noise=None, params=None):
        labels, noise = _inputs(loss_fn, vpsde, batch, generator, labels, noise)
        z = noise["x"]
        perturbed = batch_mul(vpsde.sqrt_alphas_cumprod(batch.device)[labels], batch) + batch_mul(
            vpsde.sqrt_1m_alphas_cumprod(batch.device)[labels], z
        )
        pred = get_model_fn(model, train=train, params=params)(perturbed, labels)
        return _reduce(_flat(torch.square(pred - z)), reduce_mean).mean()

    loss_fn.draws = _draws(lambda sde: sde.N, ("x",))
    return loss_fn
