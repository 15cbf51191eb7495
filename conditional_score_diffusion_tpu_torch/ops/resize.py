"""MATLAB-compatible bicubic resampling matrix, copied from the JAX
package's `ops/resize.py:resize_matrix` (numpy only).

For a fixed (in_size, out_size) pair the resize is a linear map; it is
materialized as a dense [out, in] matrix that matches MATLAB's
`contributions` algorithm (cubic kernel a=-0.5, antialiasing widens the
kernel on downscale, symmetric edge padding).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


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
