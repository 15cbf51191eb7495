"""The trained texture64 artifact's recipe, copied from
`configs/artifacts/texture64_sr_cmde.py`: 4x SR CMDE on the in-repo
texture64 patches, the 64px interpolation recipe (sigma_max_y 0.1) with
nf=64, ch_mult (1, 1, 2, 2, 3) and attention at 16/8/4."""

from __future__ import annotations

from .base import Config
from .celeba_sr import celeba_sr_interpolation_config


def get_config() -> Config:
    config = celeba_sr_interpolation_config("ours_NDV", smaxy_log10=-1.0)
    config.training.batch_size = 64
    config.training.n_iters = 60000
    config.training.log_freq = 200
    config.training.eval_freq = 2000
    config.training.snapshot_freq = 10000
    config.training.visualization_freq = 10000

    config.data.dataset = "texture64"
    config.data.base_dir = "datasets"
    config.eval.batch_size = 16
    config.eval.max_val_batches = 4

    config.model.nf = 64
    return config
