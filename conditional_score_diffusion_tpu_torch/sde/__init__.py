"""Diffusion SDEs: VE, VP, sub-VP and the multi-speed dict SDE.

A multi-speed SDE is a dict ``{'x': VESDE(...), 'y': VESDE(...)}``, as in
the JAX package.
"""

from .base import ReverseSDE, batch_mul
from .factory import build_sde, is_multispeed
from .ve import VESDE
from .vp import VPSDE, subVPSDE

__all__ = ["ReverseSDE", "batch_mul", "VESDE", "VPSDE", "subVPSDE", "build_sde", "is_multispeed"]
