"""The flagship 160px 8x-SR CMDE recipe on texture160 for training on the
card (`configs/texture160_sr_cmde.py`: batch 16, float32) with every 3x3
stride-1 conv on the port of TPU kernel 4 (``model.conv_dispatch =
"conv3x3_kernel"``, forward and input gradient; `ops/conv3x3.py`)."""

from __future__ import annotations

from .base import Config
from .texture160_sr_cmde import get_config as texture160_sr_cmde_config


def get_config() -> Config:
    config = texture160_sr_cmde_config()
    config.model.conv_dispatch = "conv3x3_kernel"
    return config
