"""The --mode test recipe of the trained texture64 artifact, copied from
`configs/artifacts/texture64_sr_cmde_test.py`: test batches 0-3 of 16,
draws 2, 3, 4, snr 0.15, 1000 steps, float32.

Two fields differ from the JAX recipe: the weights are the checkpoint's EMA
converted to a torch file in this package
(`assets/texture64_sr_cmde_ema_40000.pt`, written by
`tests/_torch_port_convert_texture64.py`), and the trees go under
``logs/texture64_run/evaluation`` (the JAX recipe writes into
``artifacts/``, whose committed trees the tests compare against).  The
fused GroupNorm+SiLU+conv3x3 tail (``model.fused_tail``) is on, as in the
port's texture160 recipes.
"""

from __future__ import annotations

import os

from .base import Config
from .texture64_sr_cmde import get_config as _train_config

EMA_ASSET = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "texture64_sr_cmde_ema_40000.pt"
)


def get_config() -> Config:
    config = _train_config()
    config.eval.base_log_dir = os.path.join("logs", "texture64_run", "evaluation")
    config.eval.first_test_batch = 0
    config.eval.last_test_batch = 4
    config.eval.draws = [2, 3, 4]
    config.model.checkpoint_path = EMA_ASSET
    config.model.fused_tail = True
    return config
