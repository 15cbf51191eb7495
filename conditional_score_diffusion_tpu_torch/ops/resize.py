"""MATLAB-compatible bicubic resize, copied from the JAX package's
`ops/resize.py`: `resize_matrix` (numpy) and `imresize` (torch).

For a fixed (in_size, out_size) pair the resize is a linear map; it is
materialized as a dense [out, in] matrix that matches MATLAB's
`contributions` algorithm (cubic kernel a=-0.5, antialiasing widens the
kernel on downscale, symmetric edge padding).
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


@lru_cache(maxsize=128)
def resize_matrix(in_size: int, out_size: int, antialias: bool = True) -> np.ndarray:
    """Dense [out_size, in_size] MATLAB-bicubic resampling matrix."""
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
