"""The ``image`` and ``haar_multiscale`` datamodules, copied from the JAX
package's `data/image_folder.py`.

``image``: a flat folder of images, ``{data.base_dir}/{data.dataset}/*``,
as NHWC float32 batches.

The files are sorted and split by ``data.split`` (train, val, test
fractions) in the order of ``np.random.default_rng(config.seed)
.permutation`` (JAX seeds the split; the reference's was unseeded).  Each
file is read as PIL RGB in [0, 1].  With ``data.crop`` (celebA) the image
is cut to its centre 108 x 108 (rows 55:163, columns 35:143 of a 218 x 178
picture), bicubic-resized to ``data.shape[1]`` and mapped to [-1, 1];
otherwise an image whose height is not ``data.shape[1]`` is bicubic-resized
to it (`degradations.bicubic_resize_np`, MATLAB's bicubic).  The train split
is shuffled by a generator seeded with ``config.seed`` and looped; val and
test come in order, once; an incomplete last batch is dropped.

``haar_multiscale``: the per-level trees `data/builder.py` writes, read
from ``{data.base_dir}/{data.dataset}_{data.image_size}/{phase}``: at
``data.level`` 0 the sorted ``*.png`` images in [0, 1], deeper the sorted
``*.npy`` approximation coefficients (a CHW array of 3 or 12 channels
turned HWC).  Batches are bare NHWC arrays, shuffled and looped on train
as ``image``'s; a conditional task splits them into detail and
approximation bands (`training/tasks.py`).
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional

import numpy as np
from PIL import Image

from . import register_datamodule
from .degradations import bicubic_resize_np

CELEBA_CROP = 108
CELEBA_SIZE = (218, 178)


def split_indices(n: int, split, seed: int):
    """The (train, val, test) index arrays of ``n`` files."""
    order = np.random.default_rng(seed).permutation(n)
    n_train = int(split[0] * n)
    n_val = int(split[1] * n)
    return order[:n_train], order[n_train : n_train + n_val], order[n_train + n_val :]


@register_datamodule(name="image")
class ImageDataModule:
    def __init__(self, config):
        self.config = config
        self.seed = config.seed

    def setup(self):
        c = self.config.data
        path = os.path.join(c.base_dir, c.dataset)
        self.files: List[str] = sorted(os.path.join(path, f) for f in os.listdir(path))
        self.train_idx, self.val_idx, self.test_idx = split_indices(len(self.files), c.split, self.seed)

    def load(self, i: int) -> np.ndarray:
        """File ``i`` (of the sorted list) as an HWC float32 image."""
        c = self.config.data
        img = np.asarray(Image.open(self.files[i]).convert("RGB"), dtype=np.float32) / 255.0
        res = c.shape[1]
        if c.get("crop", False):
            oh = (CELEBA_SIZE[0] - CELEBA_CROP) // 2
            ow = (CELEBA_SIZE[1] - CELEBA_CROP) // 2
            img = img[oh : oh + CELEBA_CROP, ow : ow + CELEBA_CROP]
            img = bicubic_resize_np(img[None], res)[0]
            img = (img - 0.5) / 0.5
        elif img.shape[0] != res:
            img = bicubic_resize_np(img[None], res)[0]
        return img

    def _iterate(self, indices, batch_size: int, train: bool, load=None):
        load = load or self.load
        rng = np.random.default_rng(self.seed)
        while True:
            order = rng.permutation(indices) if train else indices
            for i in range(0, len(order) - batch_size + 1, batch_size):
                yield np.stack([load(j) for j in order[i : i + batch_size]])
            if not train:
                return

    def train_iterator(self, batch_size: Optional[int] = None):
        return self._iterate(self.train_idx, batch_size or self.config.training.batch_size, True)

    def val_iterator(self, batch_size: Optional[int] = None):
        return self._iterate(self.val_idx, batch_size or self.config.eval.batch_size, False)

    def test_iterator(self, batch_size: Optional[int] = None):
        return self._iterate(self.test_idx, batch_size or self.config.eval.batch_size, False)


@register_datamodule(name="haar_multiscale")
class HaarDecomposedDataModule(ImageDataModule):
    def _files(self, phase: str) -> List[str]:
        c = self.config.data
        ext = "png" if c.level == 0 else "npy"
        root = os.path.join(c.base_dir, f"{c.dataset}_{c.image_size}", phase)
        return sorted(glob.glob(os.path.join(root, f"*.{ext}")))

    def setup(self):
        self.phase_files = {p: self._files(p) for p in ("train", "val", "test")}

    def load_fn(self, phase: str):
        """``load(i)``: file ``i`` of ``phase`` as an HWC float32 array."""
        level, files = self.config.data.level, self.phase_files[phase]

        def load(i: int) -> np.ndarray:
            if level == 0:
                return np.asarray(Image.open(files[i]), dtype=np.float32) / 255.0
            arr = np.load(files[i]).astype(np.float32)
            if arr.ndim == 3 and arr.shape[0] in (3, 12):  # stored CHW
                arr = arr.transpose(1, 2, 0)
            return arr

        return load

    def _phase(self, phase: str, batch_size: int):
        indices = np.arange(len(self.phase_files[phase]))
        return self._iterate(indices, batch_size, phase == "train", self.load_fn(phase))

    def train_iterator(self, batch_size: Optional[int] = None):
        return self._phase("train", batch_size or self.config.training.batch_size)

    def val_iterator(self, batch_size: Optional[int] = None):
        return self._phase("val", batch_size or self.config.eval.batch_size)

    def test_iterator(self, batch_size: Optional[int] = None):
        return self._phase("test", batch_size or self.config.eval.batch_size)
