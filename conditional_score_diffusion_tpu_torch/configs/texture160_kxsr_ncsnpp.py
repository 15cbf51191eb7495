"""The DF2K direct 4x NCSN++ recipe (`srflow.df2k_config("direct")`) on the
in-repo texture160 patches: the test split's 160px GT and its committed
40px bicubic LQ (`datasets/texture160/texture160-test{,_X4}.pklv4`), eval
batch 8; everything else is the DF2K recipe's.

The train split has no committed LQ file; :func:`write_texture160_lrhr`
writes one beside links to the committed files, and a training run points
``data.base_dir`` there (the eval split is the test split then,
``eval.loss_split``: the val split is not sent to the card).
"""

from __future__ import annotations

import os
import pickle

from .base import Config
from .srflow import df2k_config

TEXTURE160_LRHR_DIR = os.path.join("logs", "texture160_lrhr")


def get_config() -> Config:
    config = df2k_config("direct")
    config.data.dataset = "texture160"
    config.data.base_dir = "datasets"
    config.eval.batch_size = 8
    return config


def write_texture160_lrhr(base_dir: str = TEXTURE160_LRHR_DIR, source_dir: str = "datasets") -> str:
    """``{base_dir}/texture160/``: links to the committed texture160 train
    and test GT files and the test LQ file, and, where absent, the train
    split's 4x LQ file, made from its GT by the expression the repo's
    dataset script writes its LQ files with
    (`data.degradations.bicubic_lq_images`).  Returns ``base_dir``."""
    from ..data.degradations import bicubic_lq_images
    from ..data.pkl_datasets import load_pkl_images

    src = os.path.abspath(os.path.join(source_dir, "texture160"))
    d = os.path.join(base_dir, "texture160")
    os.makedirs(d, exist_ok=True)
    for name in ("texture160-train.pklv4", "texture160-test.pklv4", "texture160-test_X4.pklv4"):
        if not os.path.exists(os.path.join(d, name)):
            os.symlink(os.path.join(src, name), os.path.join(d, name))
    lq = os.path.join(d, "texture160-train_X4.pklv4")
    if not os.path.exists(lq):
        images = bicubic_lq_images(load_pkl_images(os.path.join(src, "texture160-train.pklv4")), 4)
        with open(f"{lq}.{os.getpid()}.tmp", "wb") as f:
            pickle.dump(images, f, protocol=4)
        os.replace(f"{lq}.{os.getpid()}.tmp", lq)
    return base_dir


def train_config(base_dir: str = TEXTURE160_LRHR_DIR, source_dir: str = "datasets") -> Config:
    """The recipe for training on the texture160 train split: the LQ file
    written under ``base_dir`` first where absent; the eval split is the
    test split."""
    config = get_config()
    config.data.base_dir = write_texture160_lrhr(base_dir, source_dir)
    config.eval.loss_split = "test"
    return config
