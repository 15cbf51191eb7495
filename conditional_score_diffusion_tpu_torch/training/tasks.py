"""Task definitions (JAX `training/tasks.py`): the recipe's
``training.lightning_module`` names the task that binds config and model
into the SDE of a step, batch preparation and the sampler.

Ported: ``base`` (an unconditional model), ``conditional`` (CDE/CDiffE/CMDE)
and ``conditional_decreasing_variance`` (VS-CMDE: the SDE of a step carries
the scheduled sigma_y).  The Haar tasks wait for ROADMAP.md section 1, item
7, and the deprecated single-sigma variant is not ported.
"""

from __future__ import annotations

from typing import Callable

from .. import registry
from ..sampling import get_conditional_sampling_fn, get_sampling_fn
from ..sde import build_sde
from .schedules import sigma_y_at_step

register_trainable = registry.trainables.register
get_trainable = registry.trainables.get


def create_task(config, model):
    name = config.training.get("lightning_module", "base")
    return get_trainable(name)(config, model)


@register_trainable(name="base")
class BaseTask:
    """A generative model under the recipe's SDE."""

    conditional = False

    def __init__(self, config, model):
        self.config = config
        self.model = model
        self.sde, self.sampling_eps = build_sde(config)

    def sde_for_step(self, step):
        return self.sde

    def prepare_batch(self, batch):
        """Host batch normalization hook; identity by default."""
        return batch

    def sampling_fn(self, shape, **overrides) -> Callable:
        """``fn(noise, model, show_evolution=False) -> (samples, info)``."""
        return get_sampling_fn(self.config, self.sde, shape, self.sampling_eps, **overrides)


@register_trainable(name="conditional")
class ConditionalTask(BaseTask):
    """CDE/CDiffE/CMDE."""

    conditional = True

    def sampling_fn(self, shape, **overrides) -> Callable:
        """``fn(noise, model, y, show_evolution=False) -> (samples, info)``."""
        return get_conditional_sampling_fn(self.config, self.sde, shape, self.sampling_eps, **overrides)


@register_trainable(name="conditional_decreasing_variance")
class DecreasingVarianceConditionalTask(ConditionalTask):
    """VS-CMDE: at a given step the SDE is built with the scheduled
    sigma_y (`training/schedules.py`)."""

    def sde_for_step(self, step):
        smin_y, smax_y = sigma_y_at_step(self.config, step)
        return build_sde(self.config, sigma_min_y=smin_y, sigma_max_y=smax_y)[0]

    def reconfigure(self, step: int):
        """The sampler's SDE at a checkpoint's step."""
        smin_y, smax_y = sigma_y_at_step(self.config, step)
        self.sde, self.sampling_eps = build_sde(self.config, sigma_min_y=smin_y, sigma_max_y=smax_y)
        return self.sde
