"""The image helpers of the JAX `training/callbacks.py` that the multi-scale
chain uses (`eval/multiscale.py`): `image_grid`, `_normalise_per_image` and
`haar_supergrid`, numpy on the host.  The callbacks themselves wait for
ROADMAP.md section 1, item 5.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


def image_grid(images: np.ndarray, nrow: Optional[int] = None) -> np.ndarray:
    """``[B, H, W, C]`` in [0, 1] -> one ``[H', W', C]`` grid, ``nrow``
    images a row (torchvision's ``make_grid`` without padding), clipped to
    [0, 1]; unfilled cells are 1."""
    B, H, W, C = images.shape
    nrow = nrow or int(math.ceil(math.sqrt(B)))
    ncol = int(math.ceil(B / nrow))
    grid = np.ones((ncol * H, nrow * W, C), dtype=np.float32)
    for i in range(B):
        r, c = divmod(i, nrow)
        grid[r * H : (r + 1) * H, c * W : (c + 1) * W] = np.clip(images[i], 0, 1)
    return grid


def _normalise_per_image(x: np.ndarray) -> np.ndarray:
    """Each image of ``[B, H, W, C]`` min-max scaled to [0, 1]."""
    lo = x.min(axis=(1, 2, 3), keepdims=True)
    hi = x.max(axis=(1, 2, 3), keepdims=True)
    return (x - lo) / (hi - lo + 1e-8)


def haar_supergrid(coeffs: np.ndarray) -> np.ndarray:
    """The four Haar bands of band-major ``[B, H, W, 4C]`` coefficients as a
    2x2 supergrid per image, each band min-max scaled over the batch, then
    gridded."""
    C = coeffs.shape[-1] // 4
    bands = [coeffs[..., i * C : (i + 1) * C] for i in range(4)]
    bands = [(b - b.min()) / (b.max() - b.min() + 1e-8) for b in bands]
    top = np.concatenate(bands[:2], axis=2)
    bot = np.concatenate(bands[2:], axis=2)
    return image_grid(np.concatenate([top, bot], axis=1))
