"""The texture160 DF2K direct 4x NCSN++ recipe with the fused resblock tail
and the whole-resblock kernels on (``model.fused_tail``,
``model.fused_block``)."""

from __future__ import annotations

from .base import Config
from .texture160_kxsr_ncsnpp import get_config as texture160_kxsr_ncsnpp_config


def get_config() -> Config:
    config = texture160_kxsr_ncsnpp_config()
    config.model.fused_tail = True
    config.model.fused_block = True
    return config
