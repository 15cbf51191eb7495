"""The flagship 160px 8x-SR CMDE recipe on the in-repo texture160 patches,
copied from `configs/artifacts/texture160_sr_cmde.py`, with the fused
GroupNorm+SiLU+conv3x3 resblock tail switched on (``model.fused_tail``)."""

from __future__ import annotations

from .base import Config
from .celeba_sr import celeba_sr_160_config


def get_config() -> Config:
    config = celeba_sr_160_config("ours_NDV")
    config.training.batch_size = 16
    config.training.n_iters = 60000
    config.training.log_freq = 100
    config.training.eval_freq = 2000
    config.training.snapshot_freq = 2000
    config.training.visualization_freq = 5000

    config.data.dataset = "texture160"
    config.data.base_dir = "datasets"
    config.data.datamodule = "General_PKLDataset"
    config.eval.batch_size = 8
    config.eval.max_val_batches = 4
    config.eval.first_test_batch = 0
    config.eval.last_test_batch = 4
    config.eval.draws = [2, 3, 4]

    config.model.fused_tail = True
    return config
