"""Select the loss of a recipe (JAX `losses/factory.py`): the continuous
branch, conditional where the recipe's SDE is (`sde.factory.
is_conditional_config`: a ``conditioning_approach`` or a conditional
training module), else unconditional.  The discrete SMLD/DDPM/inverse-problem
losses are not ported (ROADMAP.md section 1, item 9).

JAX keys the conditional branch on ``conditioning_approach`` alone, so a
recipe whose task is conditional without one (the DF2K direct 4x
``ncsnpp_KxSR``, a dict SDE) reaches its unconditional branch with a dict
batch and fails there; the port follows the SDE factory instead.
"""

from __future__ import annotations

from typing import Callable

from ..sde.factory import is_conditional_config
from .continuous import get_general_sde_loss_fn


def build_loss_fn(config, model, sde_template, train: bool) -> Callable:
    """``loss_fn(sde, batch, generator=None, t=None, noise=None, params=None)``
    of the recipe.  ``sde_template`` is kept for the JAX signature: the
    discrete branches would dispatch on its type."""
    if not config.training.continuous:
        raise NotImplementedError("the discrete losses are not ported (ROADMAP.md section 1, item 9)")
    return get_general_sde_loss_fn(
        model,
        conditional=is_conditional_config(config),
        train=train,
        reduce_mean=config.training.reduce_mean,
        likelihood_weighting=config.training.likelihood_weighting,
    )
