"""The flagship 160px 8x-SR recipe of each estimator on the in-repo
texture160 patches, in the pattern of `configs/artifacts/texture160_sr_cmde.py`:
`celeba_sr_160_config(approach)` with only the dataset and the schedule
changed (60,000 steps of batch 16, its log, eval and snapshot periods, eval
batch 8 over test batches 0-3), and the fused resblock tail switched on
(``model.fused_tail``).

The decreasing-variance anneal keeps its share of the run: the CelebA
recipes reach sigma_y's target at step 250,000 (VS-CMDE) or 500,000 (slow
VS-CMDE) of 500,000, so here at 30,000 and 60,000 of 60,000.  The CDE
recipe carries its unused anneal fields scaled the same way.
"""

from __future__ import annotations

from .base import Config
from .celeba_sr import celeba_sr_160_config

N_ITERS = 60000
CELEBA_N_ITERS = 500000


def texture160_sr_config(approach: str) -> Config:
    config = celeba_sr_160_config(approach)
    config.training.batch_size = 16
    config.training.n_iters = N_ITERS
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

    if "reach_target_steps" in config.model:
        config.model.reach_target_steps = config.model.reach_target_steps * N_ITERS // CELEBA_N_ITERS
    config.model.fused_tail = True
    return config


def texture160_sr_vscmde_config() -> Config:
    """VS-CMDE (``ours_DV``): sigma_max_y anneals from sqrt(3*160*160) to
    0.5 over 30,000 steps."""
    return texture160_sr_config("ours_DV")


def texture160_sr_vscmde_slow_config() -> Config:
    """The slow VS-CMDE anneal (``ours_slowDV``): to 1.0 over 60,000 steps."""
    return texture160_sr_config("ours_slowDV")


def texture160_sr_cdiffe_config() -> Config:
    """CDiffE (``song``): sigma_max_y = sigma_max_x."""
    return texture160_sr_config("song")


def texture160_sr_cde_config() -> Config:
    """CDE (``sr3``): one VE SDE on x, `ddpm_paired_SR3`."""
    return texture160_sr_config("sr3")
