"""Predictor-corrector sampling, unconditional and conditional."""

from .correctors import get_corrector
from .pc import (
    gaussian_noise,
    get_conditional_sampling_fn,
    get_pc_conditional_sampler,
    get_pc_sampler,
    get_sampling_fn,
)
from .predictors import get_predictor

__all__ = [
    "gaussian_noise",
    "get_conditional_sampling_fn",
    "get_corrector",
    "get_pc_conditional_sampler",
    "get_pc_sampler",
    "get_predictor",
    "get_sampling_fn",
]
