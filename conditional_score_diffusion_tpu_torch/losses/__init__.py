"""Denoising-score-matching losses (JAX `losses/`): the continuous branch."""

from .continuous import get_general_sde_loss_fn
from .factory import build_loss_fn

__all__ = ["build_loss_fn", "get_general_sde_loss_fn"]
