"""Samplers: predictor-corrector (unconditional, conditional, inpainting),
colorization, the probability-flow ODE, and the likelihood through it."""

from .correctors import get_corrector
from .pc import (
    gaussian_noise,
    get_conditional_sampling_fn,
    get_inpainting_fn,
    get_pc_conditional_sampler,
    get_pc_inpainter,
    get_pc_sampler,
    get_sampling_fn,
)
from .predictors import get_predictor
from .controllable import get_pc_colorizer
from .ode import get_ode_sampler
from .likelihood import get_likelihood_fn

__all__ = [
    "gaussian_noise",
    "get_conditional_sampling_fn",
    "get_corrector",
    "get_inpainting_fn",
    "get_likelihood_fn",
    "get_ode_sampler",
    "get_pc_colorizer",
    "get_pc_conditional_sampler",
    "get_pc_inpainter",
    "get_pc_sampler",
    "get_predictor",
    "get_sampling_fn",
]
