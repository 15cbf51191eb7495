"""Task definitions (JAX `training/tasks.py`): the recipe's
``training.lightning_module`` names the task that binds config and model
into the SDE of a step, batch preparation and the sampler.

Ported: ``base`` (an unconditional model), ``conditional`` (CDE/CDiffE/CMDE;
a bare array batch of the ``haar_multiscale`` datamodule is split into its
9 Haar detail bands ``x`` and approximation band ``y``, where the JAX
task hands the array to a loss that indexes ``batch["x"]`` and fails),
``conditional_decreasing_variance`` (VS-CMDE: the SDE of a step carries
the scheduled sigma_y), its older single-sigma variant
``deprecated_conditional_decreasing_variance``, and the Haar tasks
``haar_conditional_decreasing_variance`` (VS-CMDE with the Haar helpers)
and ``haar_multiscale`` (a model of Haar coefficients, whose
``inpaint_hf`` fills the detail bands given the DC band).
"""

from __future__ import annotations

from typing import Callable

import torch

from .. import registry
from ..ops import haar as haar_ops
from ..sampling import get_conditional_sampling_fn, get_inpainting_fn, get_sampling_fn
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

    def inpainting_fn(self, n_steps_each: int = 1) -> Callable:
        """``fn(noise, model, data, mask, show_evolution=False) -> (samples, info)``."""
        return get_inpainting_fn(self.config, self.sde, self.sampling_eps, n_steps_each)


@register_trainable(name="conditional")
class ConditionalTask(BaseTask):
    """CDE/CDiffE/CMDE."""

    conditional = True

    def prepare_batch(self, batch):
        """``{'x', 'y'}`` as it is; a bare NHWC array (the ``haar_multiscale``
        trees: images at level 0, approximation bands deeper) as ``{'x':
        detail bands, 'y': approximation band}`` of its Haar transform."""
        if isinstance(batch, dict):
            return batch
        z = haar_ops.haar_forward(torch.from_numpy(batch)).numpy()
        c = batch.shape[-1]
        return {"x": z[..., c:], "y": z[..., :c]}

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


@register_trainable(name="deprecated_conditional_decreasing_variance")
class DeprecatedDecreasingVarianceConditionalTask(DecreasingVarianceConditionalTask):
    """The older single-sigma variant: only sigma_max_y anneals; sigma_min_y
    stays at the recipe's value."""

    def sde_for_step(self, step):
        return build_sde(self.config, sigma_max_y=sigma_y_at_step(self.config, step)[1])[0]

    def reconfigure(self, step: int):
        _, smax_y = sigma_y_at_step(self.config, step)
        self.sde, self.sampling_eps = build_sde(self.config, sigma_max_y=float(smax_y))
        return self.sde


@register_trainable(name="haar_conditional_decreasing_variance")
class HaarDecreasingVarianceConditionalTask(DecreasingVarianceConditionalTask):
    """VS-CMDE in Haar space: the detail bands given the approximation band,
    with the fixed orthonormal Haar transform at hand."""

    haar_forward = staticmethod(haar_ops.haar_forward)
    haar_backward = staticmethod(haar_ops.haar_backward)
    get_dc_coefficients = staticmethod(haar_ops.get_dc_coefficients)
    get_hf_coefficients = staticmethod(haar_ops.get_hf_coefficients)


@register_trainable(name="haar_multiscale")
class HaarMultiScaleTask(BaseTask):
    """An unconditional model of Haar coefficients: image batches are
    transformed before the loss; the sampler returns coefficients or, with
    ``space="image"``, images."""

    haar_forward = staticmethod(haar_ops.haar_forward)
    haar_backward = staticmethod(haar_ops.haar_backward)

    def prepare_batch(self, batch):
        """A host batch (NHWC numpy) of level-0 images as Haar coefficients;
        deeper levels are stored as coefficients already."""
        if self.config.data.get("level", 0) == 0 and batch.shape[-1] == 3:
            return haar_ops.haar_forward(torch.from_numpy(batch)).numpy()
        return batch

    def sampling_fn(self, shape, space: str = "haar", **overrides) -> Callable:
        """``fn(noise, model, show_evolution=False) -> (samples, info)``, the
        samples as Haar coefficients or (``space="image"``) images."""
        base_fn = get_sampling_fn(self.config, self.sde, shape, self.sampling_eps, **overrides)
        if space == "haar":
            return base_fn

        def image_fn(noise, model, **kw):
            samples, info = base_fn(noise, model, **kw)
            return haar_ops.haar_backward(samples), info

        return image_fn

    def inpaint_hf(self, noise, model, dc_coefficients, n_steps_each: int = 1):
        """The detail bands given the DC band (NHWC, C channels) by masked PC
        inpainting: the state is the DC band in the first C channels and
        zeros in the 3C detail channels, the mask 1 on the DC.  Returns
        ``(coefficients, info)``."""
        B, H, W, C = dc_coefficients.shape
        full = torch.cat([dc_coefficients, dc_coefficients.new_zeros(B, H, W, 3 * C)], dim=-1)
        mask = torch.zeros_like(full)
        mask[..., :C] = 1.0
        return self.inpainting_fn(n_steps_each)(noise, model, full, mask)
