"""Degradations on host numpy batches, copied from the JAX package's
`data/degradations.py`: `bicubic_resize_np`, `sr_degrade`, `grayscale`
(the colorization task's y and the colorizer's input), `random_square_mask`
(the inpainting task's mask, which the offline pipeline re-rolls),
`inpainting_degrade`, and the LRHR pairs' joint `random_flip`,
`random_rotation` and `random_crop`."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..ops.resize import resize_matrix


def bicubic_resize_np(batch: np.ndarray, out_size: int) -> np.ndarray:
    """Batched MATLAB-bicubic resize on host (NHWC numpy)."""
    B, H, W, C = batch.shape
    Mh = resize_matrix(H, out_size, antialias=True)
    Mw = resize_matrix(W, out_size, antialias=True)
    out = np.einsum("oh,bhwc->bowc", Mh, batch)
    out = np.einsum("pw,bowc->bopc", Mw, out)
    return out.astype(batch.dtype)


def nearest_upsample_np(batch: np.ndarray, factor: int) -> np.ndarray:
    return batch.repeat(factor, axis=1).repeat(factor, axis=2)


def sr_degrade(batch: np.ndarray, scale: int) -> np.ndarray:
    """HR -> bicubic LR -> nearest-neighbor back to HR size."""
    H = batch.shape[1]
    lr = bicubic_resize_np(batch, H // scale)
    return nearest_upsample_np(lr, scale)


def grayscale(batch: np.ndarray) -> np.ndarray:
    """ITU-R 601 luma of an NHWC RGB batch, as one channel."""
    w = np.array([0.299, 0.587, 0.114], dtype=batch.dtype)
    return (batch @ w)[..., None]


def bicubic_lq_images(images, scale: int):
    """uint8 HWC images -> their bicubic 1/``scale`` LQ images, uint8, by the
    expression the repo's dataset script writes its ``*_X{scale}.pklv4``
    files with (`scripts/make_texture_dataset.py`)."""
    return [
        np.clip(
            bicubic_resize_np(im[None].astype(np.float32) / 255.0, im.shape[0] // scale)[0] * 255.0, 0, 255,
        ).astype(np.uint8)
        for im in images
    ]


def random_square_mask(
    shape: Tuple[int, int, int, int],
    mask_coverage: float,
    rng: np.random.Generator,
    seeds: Optional[np.ndarray] = None,
) -> np.ndarray:
    """[B,H,W,1] mask, 1 inside the square to inpaint; ``seeds`` (one per
    item) re-rolls each item's square from its own generator."""
    B, H, W, _ = shape
    mask_size = int(np.sqrt(mask_coverage * H * W))
    mask = np.zeros((B, H, W, 1), dtype=np.float32)
    for i in range(B):
        r = np.random.default_rng(int(seeds[i])) if seeds is not None else rng
        sx = r.integers(0, H - mask_size + 1) if H > mask_size else 0
        sy = r.integers(0, W - mask_size + 1) if W > mask_size else 0
        mask[i, sx : sx + mask_size, sy : sy + mask_size, 0] = 1.0
    return mask


def inpainting_degrade(batch: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """``batch`` with the masked square (``mask`` 1) set to 0."""
    return batch * (1.0 - mask)


def random_flip(*imgs, rng: np.random.Generator):
    """The HWC images flipped left-right together where one draw of ``rng``
    is below 0.5."""
    if rng.random() < 0.5:
        return tuple(np.ascontiguousarray(img[:, ::-1, :]) for img in imgs)
    return imgs


def random_rotation(*imgs, rng: np.random.Generator):
    """The HWC images rotated together by k quarter turns, k drawn from
    ``rng`` in [0, 4)."""
    k = int(rng.integers(0, 4))
    return tuple(np.ascontiguousarray(np.rot90(img, k, axes=(0, 1))) for img in imgs)


def random_crop(hr: np.ndarray, lr: np.ndarray, size: int, scale: int, rng: np.random.Generator):
    """One crop of an HWC (hr, lr) pair: ``size`` square on hr, ``size //
    scale`` on lr at the matching place; the lr corner drawn row then
    column, each only where lr is larger than its crop."""
    size_lr = size // scale
    h_lr = int(rng.integers(0, lr.shape[0] - size_lr + 1)) if lr.shape[0] > size_lr else 0
    w_lr = int(rng.integers(0, lr.shape[1] - size_lr + 1)) if lr.shape[1] > size_lr else 0
    lr_c = lr[h_lr : h_lr + size_lr, w_lr : w_lr + size_lr]
    hr_c = hr[h_lr * scale : h_lr * scale + size, w_lr * scale : w_lr * scale + size]
    return hr_c, lr_c
