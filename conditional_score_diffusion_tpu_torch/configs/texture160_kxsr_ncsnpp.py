"""The DF2K direct 4x NCSN++ recipe (`srflow.df2k_config("direct")`) on the
in-repo texture160 patches: the test split's 160px GT and its committed
40px bicubic LQ (`datasets/texture160/texture160-test{,_X4}.pklv4`), eval
batch 8; everything else is the DF2K recipe's."""

from __future__ import annotations

from .base import Config
from .srflow import df2k_config


def get_config() -> Config:
    config = df2k_config("direct")
    config.data.dataset = "texture160"
    config.data.base_dir = "datasets"
    config.eval.batch_size = 8
    return config
