"""The texture64 VS-CMDE recipe, copied from
`configs/artifacts/texture64_sr_dv.py`: the 64px 4x-SR interpolation
recipe with the ``ours_DV`` estimator on the in-repo texture64 patches,
nf=64, sigma_max_y annealing from sqrt(3*64*64) to 0.1 over 4,000 of its
6,000 steps."""

from __future__ import annotations

import math

from .base import Config
from .celeba_sr import celeba_sr_interpolation_config


def get_config() -> Config:
    config = celeba_sr_interpolation_config("ours_DV", smaxy_log10=-1.0)
    config.training.batch_size = 64
    config.training.n_iters = 6000
    config.training.log_freq = 100
    config.training.eval_freq = 1000
    config.training.snapshot_freq = 1000
    config.training.visualization_freq = 3000

    config.data.dataset = "texture64"
    config.data.base_dir = "datasets"
    config.eval.batch_size = 16
    config.eval.max_val_batches = 2
    config.eval.first_test_batch = 0
    config.eval.last_test_batch = 2
    config.eval.draws = [2, 3]

    config.model.nf = 64
    # the interpolation recipe keeps the 128px anneal start for ours_DV;
    # the start is sqrt(prod shape_y) at this recipe's 64px
    config.model.sigma_max_y = float(math.sqrt(math.prod(config.data.shape_y)))
    config.model.sigma_max_y_target = 0.1
    config.model.reach_target_steps = 4000
    return config
