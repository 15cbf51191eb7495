"""Select the loss of a recipe (JAX `losses/factory.py`): the continuous
branch, conditional where the recipe's SDE is (`sde.factory.
is_conditional_config`: a ``conditioning_approach`` or a conditional
training module), else unconditional; the discrete branch by the SDE's
type, as JAX: a multi-speed dict SDE takes the inverse-problem SMLD loss,
a VESDE SMLD (without likelihood weighting, as JAX calls it), a VPSDE the
DDPM loss.

JAX keys the conditional branch on ``conditioning_approach`` alone, so a
recipe whose task is conditional without one (the DF2K direct 4x
``ncsnpp_KxSR``, a dict SDE) reaches its unconditional branch with a dict
batch and fails there; the port follows the SDE factory instead.
"""

from __future__ import annotations

from typing import Callable

from ..sde import VESDE, VPSDE, is_multispeed
from ..sde.factory import is_conditional_config
from .continuous import get_general_sde_loss_fn
from .discrete import get_ddpm_loss_fn, get_inverse_problem_smld_loss_fn, get_smld_loss_fn


def build_loss_fn(config, model, sde_template, train: bool) -> Callable:
    """``loss_fn(sde, batch, generator=None, t=None, noise=None, params=None)``
    of the recipe (discrete: ``labels=`` in place of ``t=``).
    ``sde_template`` is inspected for its type only, to pick a discrete
    branch; the live SDE is passed to the returned function."""
    reduce_mean = config.training.reduce_mean
    if config.training.continuous:
        return get_general_sde_loss_fn(
            model,
            conditional=is_conditional_config(config),
            train=train,
            reduce_mean=reduce_mean,
            likelihood_weighting=config.training.likelihood_weighting,
        )
    if is_multispeed(sde_template):
        return get_inverse_problem_smld_loss_fn(
            model, train=train, reduce_mean=reduce_mean, likelihood_weighting=config.training.likelihood_weighting
        )
    if isinstance(sde_template, VESDE):
        return get_smld_loss_fn(model, train=train, reduce_mean=reduce_mean)
    if isinstance(sde_template, VPSDE):
        return get_ddpm_loss_fn(model, train=train, reduce_mean=reduce_mean)
    raise ValueError(f"Discrete training for {type(sde_template).__name__} is not supported.")
