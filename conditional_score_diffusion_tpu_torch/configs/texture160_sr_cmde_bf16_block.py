"""The flagship 160px 8x-SR CMDE recipe on texture160 as the JAX bench runs
it (`bench.py`: ``BENCH_FUSED_BLOCK=1``): the fused resblock tail and the
whole-resblock kernels on (``model.fused_tail``, ``model.fused_block``).

The compute dtype is the caller's choice, as in `bench.py`: pass
``compute_dtype=torch.bfloat16`` to `models.wrappers.get_score_fn`.
"""

from __future__ import annotations

from .base import Config
from .texture160_sr_cmde import get_config as texture160_sr_cmde_config


def get_config() -> Config:
    config = texture160_sr_cmde_config()
    config.model.fused_tail = True
    config.model.fused_block = True
    return config
