"""The test split of a `.pklv4` dataset, as the JAX package's
`data/pkl_datasets.py` batches it.

Copied from there: `pkl_paths`, `load_pkl_images`, and the test phase of two
datamodules (no flip, crop or rotation at test time; the numpy batch
assembly of `data/native.py`, which its C++ extension only speeds up):

* `General_PKLDataset`: GT images with on-the-fly super-resolution
  degradation (y is the bicubic LR upsampled back by nearest neighbour);
* `LRHR_PKLDataset`: stored LQ/GT pairs, y the LQ image as it is (or
  upsampled by nearest neighbour where the recipe sets ``upscale_lr``).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Iterator, List

import numpy as np

from .degradations import bicubic_resize_np, nearest_upsample_np, sr_degrade

_PKL_FILES = {
    # dataset -> phase -> (LQ_file, GT_file)
    "DF2K": {
        "train": ("DF2K-tr_X4.pklv4", "DF2K-tr.pklv4"),
        "val": ("DIV2K-va_X4.pklv4", "DIV2K-va.pklv4"),
        "test": ("DIV2K-teFullMod8_X4.pklv4", "DIV2K-teFullMod8.pklv4"),
    },
    "celebA-HQ-160": {
        "train": ("CelebAHq_160_MBic_tr_X8.pklv4", "CelebAHq_160_MBic_tr.pklv4"),
        "val": ("CelebAHq_160_MBic_va_X8.pklv4", "CelebAHq_160_MBic_va.pklv4"),
        "test": ("CelebAHq_160_MBic_va_X8.pklv4", "CelebAHq_160_MBic_va.pklv4"),
    },
}


def pkl_paths(config, phase: str) -> Dict[str, str]:
    dataset = config.data.dataset
    base = os.path.join(config.data.base_dir, dataset)
    if dataset not in _PKL_FILES:
        # locally built datasets: {base_dir}/{dataset}/{dataset}-{phase}.pklv4 (GT)
        # and {dataset}-{phase}_X{scale}.pklv4 (LQ, optional)
        gt = f"{dataset}-{phase}.pklv4"
        scale = config.data.get("scale", 4)
        lq = f"{dataset}-{phase}_X{scale}.pklv4"
        if os.path.exists(os.path.join(base, gt)):
            return {"LQ": os.path.join(base, lq), "GT": os.path.join(base, gt)}
        raise NotImplementedError(f"{dataset} is not supported.")
    lq, gt = _PKL_FILES[dataset][phase]
    return {"LQ": os.path.join(base, lq), "GT": os.path.join(base, gt)}


def load_pkl_images(path: str, n_max: int = int(1e9)) -> List[np.ndarray]:
    """HWC uint8 image list from a .pklv4 file (a pickle this repo's dataset
    scripts write; load only trusted files)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        images = pickle.load(f)
    if len(images) == 0:
        raise ValueError(f"{path} holds no images")
    return [np.asarray(im) for im in images[:n_max]]


def assemble_batch(images: List[np.ndarray]) -> np.ndarray:
    """uint8 HWC images -> one float32 [0, 1] NHWC batch."""
    return np.stack([im.astype(np.float32) / 255.0 for im in images])


def make_sr_batch(images: List[np.ndarray], image_size: int, scale: int) -> Dict[str, np.ndarray]:
    """``{'x': HR, 'y': SR-degraded HR}`` for one test batch."""
    x = assemble_batch(images)
    if x.shape[1] != image_size:
        x = bicubic_resize_np(x, image_size)
    return {"x": x, "y": sr_degrade(x, scale)}


def make_lrhr_batch(lr: List[np.ndarray], hr: List[np.ndarray], upscale_lr: bool) -> Dict[str, np.ndarray]:
    """``{'x': HR, 'y': LQ}`` of stored pairs (LQ upsampled by nearest
    neighbour to the HR size when ``upscale_lr``)."""
    x, y = assemble_batch(hr), assemble_batch(lr)
    if upscale_lr:
        y = nearest_upsample_np(y, x.shape[1] // y.shape[1])
    return {"x": x, "y": y}


def iter_test_batches(config, batch_size=None) -> Iterator[Dict[str, np.ndarray]]:
    """The test split in order, as the recipe's datamodule's `test_iterator`
    yields it (incomplete last batch dropped)."""
    bs = batch_size or config.eval.batch_size
    paths = pkl_paths(config, "test")
    hr = load_pkl_images(paths["GT"])
    if config.data.datamodule == "LRHR_PKLDataset":
        lr = load_pkl_images(paths["LQ"])
        if len(lr) != len(hr):
            raise ValueError(f"{len(lr)} LQ images for {len(hr)} GT images")
        upscale_lr = config.data.get("upscale_lr", False)
        for i in range(0, len(hr) - bs + 1, bs):
            yield make_lrhr_batch(lr[i : i + bs], hr[i : i + bs], upscale_lr)
        return
    if config.data.task != "super-resolution":
        raise NotImplementedError(f"task {config.data.task!r} is not ported")
    for i in range(0, len(hr) - bs + 1, bs):
        yield make_sr_batch(hr[i : i + bs], config.data.image_size, config.data.get("scale", 4))
