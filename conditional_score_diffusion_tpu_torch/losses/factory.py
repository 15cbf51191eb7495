"""Select the loss of a recipe (JAX `losses/factory.py`): the continuous
branch, conditional where the recipe names a ``conditioning_approach``,
else unconditional.  The discrete SMLD/DDPM/inverse-problem losses are not ported
(ROADMAP.md section 1, item 9)."""

from __future__ import annotations

from typing import Callable

from .continuous import get_general_sde_loss_fn


def build_loss_fn(config, model, sde_template, train: bool) -> Callable:
    """``loss_fn(sde, batch, generator=None, t=None, noise=None, params=None)``
    of the recipe.  ``sde_template`` is kept for the JAX signature: the
    discrete branches would dispatch on its type."""
    if not config.training.continuous:
        raise NotImplementedError("the discrete losses are not ported (ROADMAP.md section 1, item 9)")
    return get_general_sde_loss_fn(
        model,
        conditional="conditioning_approach" in config.training,
        train=train,
        reduce_mean=config.training.reduce_mean,
        likelihood_weighting=config.training.likelihood_weighting,
    )
