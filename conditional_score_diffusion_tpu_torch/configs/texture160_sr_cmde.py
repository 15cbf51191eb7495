"""The flagship 160px 8x-SR CMDE recipe on the in-repo texture160 patches,
copied from `configs/artifacts/texture160_sr_cmde.py`, with the fused
GroupNorm+SiLU+conv3x3 resblock tail switched on (``model.fused_tail``)."""

from __future__ import annotations

from .base import Config
from .texture160_sr import texture160_sr_config


def get_config() -> Config:
    return texture160_sr_config("ours_NDV")
