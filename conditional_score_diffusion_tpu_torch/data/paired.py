"""Paired A/B datamodules, copied from the JAX package's `data/paired.py`:
``paired`` (image-to-image pairs such as edges2shoes, and MRI->PET slices)
and ``DUAL-GLOW`` (MRI/PET volumes), one implementation.

A split is the tree ``{data.base_dir}/{data.dataset}/{phase}/A|B``, its
files paired in sorted order; domain A is the condition y, domain B the
target x.  Images (jpg, png, ...) are read as RGB in [0, 1].  ``.npy``
scans, 2-D slices or 3-D volumes, are mapped to [0, 1] by ``data.range_y``
(A) / ``data.range_x`` (B), or by the array's own min and max; a slice
gets a channel axis, and so does a volume where ``data.shape_x`` has four
entries (C, H, W, D).  With ``data.use_flip`` each train pair is flipped
along axis -2 (an image's width, a volume's last axis) where a draw of the
split's generator is below 0.5, as in JAX.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from . import register_datamodule

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".tif", ".tiff", ".webp")
PHASES = ("train", "val", "test")


def normalise(x: np.ndarray, value_range=None) -> np.ndarray:
    """Map into [0, 1] by the given (min, max) range, or the array's own."""
    if value_range is None:
        lo, hi = float(x.min()), float(x.max())
    else:
        lo, hi = value_range
    return (x - lo) / (hi - lo)


def load_image_paths(root: str, phase: str) -> Dict[str, List[str]]:
    """The sorted A and B files of ``{root}/{phase}``."""
    paths = {}
    for key in ("A", "B"):
        d = os.path.join(root, phase, key)
        paths[key] = sorted(
            f for f in glob.glob(os.path.join(d, "*")) if f.lower().endswith(IMG_EXTENSIONS + (".npy",))
        )
    if len(paths["A"]) != len(paths["B"]) or not paths["A"]:
        raise FileNotFoundError(f"bad paired tree at {root}/{phase}: {len(paths['A'])} A, {len(paths['B'])} B files")
    return paths


class PairedDataModule:
    """The split iterators of ``paired`` and ``DUAL-GLOW`` (JAX
    `PairedDataModule`, `DualGlowDataModule`): ``{'x': B, 'y': A}`` batches,
    the train split shuffled and looped, the others in order, once (the
    incomplete last batch dropped)."""

    def __init__(self, config):
        self.config = config
        self.seed = config.seed

    def setup(self):
        root = os.path.join(self.config.data.base_dir, self.config.data.dataset)
        self.paths = {p: load_image_paths(root, p) for p in PHASES}
        self.is_npy = os.path.splitext(self.paths["train"]["A"][0])[1].lower() == ".npy"

    def load_pair(self, phase: str, i: int):
        """``(A, B)`` of item ``i`` of ``phase``, float32 in [0, 1]."""
        c = self.config.data
        a_path, b_path = self.paths[phase]["A"][i], self.paths[phase]["B"][i]
        if self.is_npy:
            A = normalise(np.load(a_path).astype(np.float32), c.get("range_y", None))
            B = normalise(np.load(b_path).astype(np.float32), c.get("range_x", None))
            if A.ndim == 2 or (A.ndim == 3 and len(c.shape_x) == 4):
                A, B = A[..., None], B[..., None]
        else:
            A = np.asarray(Image.open(a_path).convert("RGB"), np.float32) / 255.0
            B = np.asarray(Image.open(b_path).convert("RGB"), np.float32) / 255.0
        return A, B

    def _iterate(self, phase: str, batch_size: int, train: bool):
        rng = np.random.default_rng(self.seed)
        n = len(self.paths[phase]["A"])
        flip = self.config.data.get("use_flip", False) and train
        while True:
            order = rng.permutation(n) if train else np.arange(n)
            for i in range(0, n - batch_size + 1, batch_size):
                ys, xs = [], []
                for j in order[i : i + batch_size]:
                    A, B = self.load_pair(phase, int(j))
                    if flip and rng.random() < 0.5:
                        A = np.ascontiguousarray(np.flip(A, axis=-2))
                        B = np.ascontiguousarray(np.flip(B, axis=-2))
                    ys.append(A)
                    xs.append(B)
                yield {"x": np.stack(xs), "y": np.stack(ys)}
            if not train:
                return

    def train_iterator(self, batch_size: Optional[int] = None):
        return self._iterate("train", batch_size or self.config.training.batch_size, True)

    def val_iterator(self, batch_size: Optional[int] = None):
        return self._iterate("val", batch_size or self.config.eval.batch_size, False)

    def test_iterator(self, batch_size: Optional[int] = None):
        return self._iterate("test", batch_size or self.config.eval.batch_size, False)


register_datamodule(PairedDataModule, name="paired")
register_datamodule(PairedDataModule, name="DUAL-GLOW")
