"""MATLAB-compatible bicubic resize, copied from the JAX package's
`ops/resize.py`: `resize_matrix` (numpy) and `imresize` (torch); and the
bilinear resize of `jax.image.resize(..., "bilinear")`, which the JAX
Inception runs to 299 (`resize_bilinear`).

For a fixed (in_size, out_size) pair the resize is a linear map; it is
materialized as a dense [out, in] matrix.  The cubic one matches MATLAB's
`contributions` algorithm (cubic kernel a=-0.5, antialiasing widens the
kernel on downscale, symmetric edge padding); the triangle one JAX's
`compute_weight_mat` (half-pixel centres, the kernel widened by the
shrink factor when it shrinks, each output's weights normalised to sum 1,
computed in float32 as JAX does).  `F.interpolate`'s bilinear differs from
it where it shrinks.
"""

from __future__ import annotations

import contextlib
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch


def _cubic(x: np.ndarray) -> np.ndarray:
    """MATLAB cubic kernel (a = -0.5)."""
    ax = np.abs(x)
    ax2, ax3 = ax**2, ax**3
    f = (1.5 * ax3 - 2.5 * ax2 + 1.0) * (ax <= 1)
    f += (-0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0) * ((1 < ax) & (ax <= 2))
    return f


def _triangle_matrix(in_size: int, out_size: int, antialias: bool) -> np.ndarray:
    """`jax.image.resize`'s linear weights, float32, as [out, in]."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0)) if antialias else f32(1.0)
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - x)
    total = np.sum(weights, axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).T.astype(f32)


@lru_cache(maxsize=128)
def resize_matrix(in_size: int, out_size: int, antialias: bool = True, kernel: str = "cubic") -> np.ndarray:
    """Dense [out_size, in_size] resampling matrix: MATLAB's bicubic
    (``kernel="cubic"``) or `jax.image.resize`'s bilinear (``"triangle"``)."""
    if kernel == "triangle":
        return _triangle_matrix(in_size, out_size, antialias)
    if kernel != "cubic":
        raise ValueError(f"unknown resize kernel {kernel!r}; known: cubic, triangle")
    scale = out_size / in_size
    if antialias and scale < 1:
        kernel_width = 4.0 / scale
        kernel = lambda x: scale * _cubic(scale * x)
    else:
        kernel_width = 4.0
        kernel = _cubic

    x = np.arange(1, out_size + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    P = int(np.ceil(kernel_width)) + 2
    indices = left[:, None] + np.arange(P)[None, :]  # 1-based
    weights = kernel(u[:, None] - indices)
    weights = weights / np.sum(weights, axis=1, keepdims=True)

    # symmetric (mirror) boundary handling, MATLAB-style
    aux = np.concatenate([np.arange(1, in_size + 1), np.arange(in_size, 0, -1)])
    idx = aux[((indices - 1).astype(np.int64)) % (2 * in_size)] - 1  # 0-based

    M = np.zeros((out_size, in_size), dtype=np.float64)
    for r in range(out_size):
        np.add.at(M[r], idx[r], weights[r])
    return M.astype(np.float32)


@contextlib.contextmanager
def full_float32():
    """Float32 matmuls and cuDNN convolutions in full float32 (TF32 off)
    inside the block, the switches restored after it: the metrics and the
    resize feed PSNR and SSIM, which TF32's ~3 digits would move."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn


def imresize(
    img: torch.Tensor,
    scale: Optional[float] = None,
    out_shape: Optional[Tuple[int, int]] = None,
    antialias: bool = True,
) -> torch.Tensor:
    """MATLAB-equivalent bicubic resize of NHWC (or HWC) images (JAX
    `ops/resize.py:imresize`): two einsums over :func:`resize_matrix`, in
    float32 with TF32 off (float64 for a float64 image), out in ``img.dtype``."""
    squeeze = img.ndim == 3
    if squeeze:
        img = img[None]
    B, H, W, C = img.shape
    if out_shape is None:
        if scale is None:
            raise ValueError("imresize needs a scale or an out_shape")
        out_h, out_w = int(np.ceil(H * scale)), int(np.ceil(W * scale))
    else:
        out_h, out_w = out_shape
    dtype = torch.float64 if img.dtype == torch.float64 else torch.float32
    Mh = torch.from_numpy(resize_matrix(H, out_h, antialias)).to(img.device, dtype)
    Mw = torch.from_numpy(resize_matrix(W, out_w, antialias)).to(img.device, dtype)
    with full_float32():
        out = torch.einsum("oh,bhwc->bowc", Mh, img.to(dtype))
        out = torch.einsum("pw,bowc->bopc", Mw, out)
    out = out.to(img.dtype)
    return out[0] if squeeze else out


def resize_bilinear(img: torch.Tensor, out_shape: Tuple[int, int]) -> torch.Tensor:
    """`jax.image.resize(img, (B, *out_shape, C), "bilinear")` of NHWC images:
    two einsums over the triangle :func:`resize_matrix` (antialiased where
    it shrinks), in ``img``'s floating type with TF32 off; a side already at
    its size is left as it is, as JAX leaves it."""
    _, H, W, _ = img.shape
    out_h, out_w = out_shape
    with full_float32():
        if out_h != H:
            Mh = torch.from_numpy(resize_matrix(H, out_h, True, "triangle")).to(img.device, img.dtype)
            img = torch.einsum("oh,bhwc->bowc", Mh, img)
        if out_w != W:
            Mw = torch.from_numpy(resize_matrix(W, out_w, True, "triangle")).to(img.device, img.dtype)
            img = torch.einsum("pw,bowc->bopc", Mw, img)
    return img
