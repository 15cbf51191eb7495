"""Diffusion SDEs (the VE family and the multi-speed dict SDE).

A multi-speed SDE is a dict ``{'x': VESDE(...), 'y': VESDE(...)}``, as in
the JAX package.
"""

from .base import ReverseSDE, batch_mul
from .factory import build_sde, is_multispeed
from .ve import VESDE

__all__ = ["ReverseSDE", "batch_mul", "VESDE", "build_sde", "is_multispeed"]
