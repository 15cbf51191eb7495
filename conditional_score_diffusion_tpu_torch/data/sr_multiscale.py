"""The ``bicubic_multiscale`` datamodule, copied from the JAX package's
`data/sr_multiscale.py`: celebA ``*.jpg`` files under ``{data.base_dir}/
{data.dataset}`` as ``{'x', 'y'}`` super-resolution pairs of one level of
the bicubic pyramid.

The sorted files are split by celebA's fixed indices: train the first
162,770, val and test each the first 5,000 of a shuffle of files
162,770-182,636 (one generator seeded with ``config.seed``, drawn for val
then test).  Each image, in [0, 1], is cropped to ``data.target_resolution``
(train: a corner drawn from the phase's generator, row then column, where
the image is larger; otherwise the centre), then ``x`` is its bicubic
resize to ``target_resolution // 2**level`` and ``y`` to ``target_resolution
// 2**(level + 1)`` (`degradations.bicubic_resize_np`, MATLAB's bicubic).
The train split is shuffled by that generator and looped; val and test come
in order, once; an incomplete last batch is dropped.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np
from PIL import Image

from . import register_datamodule
from .degradations import bicubic_resize_np

CELEBA_TRAIN, CELEBA_VAL_END, CELEBA_EVAL = 162770, 182637, 5000


def celeba_split(paths, phase: str, rng: np.random.Generator):
    """celebA's fixed split of the sorted file list."""
    if phase == "train":
        return paths[:CELEBA_TRAIN]
    val = list(paths[CELEBA_TRAIN:CELEBA_VAL_END])
    rng.shuffle(val)
    return val[:CELEBA_EVAL]


@register_datamodule(name="bicubic_multiscale")
class SuperResolutionDataModule:
    def __init__(self, config):
        self.config = config
        self.seed = config.seed

    def setup(self):
        c = self.config.data
        all_paths = sorted(glob.glob(os.path.join(c.base_dir, c.dataset, "*.jpg")))
        rng = np.random.default_rng(self.seed)
        self.phase_paths = {p: celeba_split(all_paths, p, rng) for p in ("train", "val", "test")}

    def _iterate(self, phase: str, batch_size: int):
        c = self.config.data
        level, gt = int(c.level), c.target_resolution
        hr_size, lr_size = gt // 2**level, gt // 2 ** (level + 1)
        train = phase == "train"
        rng = np.random.default_rng(self.seed)
        paths = self.phase_paths[phase]

        def crop(img):
            H, W, _ = img.shape
            if train:
                top = int(rng.integers(0, H - gt + 1)) if H > gt else 0
                left = int(rng.integers(0, W - gt + 1)) if W > gt else 0
            else:
                top, left = (H - gt) // 2, (W - gt) // 2
            return img[top : top + gt, left : left + gt]

        while True:
            order = rng.permutation(len(paths)) if train else np.arange(len(paths))
            for i in range(0, len(paths) - batch_size + 1, batch_size):
                gt_batch = np.stack([
                    crop(np.asarray(Image.open(paths[j]).convert("RGB"), np.float32) / 255.0)
                    for j in order[i : i + batch_size]
                ])
                yield {"x": bicubic_resize_np(gt_batch, hr_size), "y": bicubic_resize_np(gt_batch, lr_size)}
            if not train:
                return

    def train_iterator(self, batch_size: Optional[int] = None):
        return self._iterate("train", batch_size or self.config.training.batch_size)

    def val_iterator(self, batch_size: Optional[int] = None):
        return self._iterate("val", batch_size or self.config.eval.batch_size)

    def test_iterator(self, batch_size: Optional[int] = None):
        return self._iterate("test", batch_size or self.config.eval.batch_size)
