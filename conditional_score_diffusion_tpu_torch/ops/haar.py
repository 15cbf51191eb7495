"""The orthonormal 2x2 Haar wavelet transform on NHWC tensors (JAX
`ops/haar.py`), exactly invertible: a space-to-depth by 2 and a fixed 4x4
orthonormal matrix.

``haar_forward_2d`` gives the coefficients channel-major (4 bands per input
channel) in the band order ``[LH, LL, HL, HH]``; `permute_channels` goes to
band-major and swaps bands 0 and 1 on the way, so :func:`haar_forward` puts
the approximation (DC) band first: ``[LL (C) | LH, HL, HH (3C)]``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# Rows: output bands [LH, LL, HL, HH]; columns: the 2x2 patch [tl, tr, bl, br].
_H = np.array(
    [
        [1, -1, 1, -1],  # LH (horizontal detail)
        [1, 1, 1, 1],  # LL (approximation)
        [1, 1, -1, -1],  # HL (vertical detail)
        [1, -1, -1, 1],  # HH (diagonal detail)
    ],
    dtype=np.float32,
) / 2.0


def _mix(v: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """``out[..., k] = (m[k, 0] v0 + m[k, 1] v1) + (m[k, 2] v2 + m[k, 3] v3)``
    over the last axis (4) of ``v`` in float32: the products are exact (the
    entries are +-1/2), and the sums pair as XLA's CPU dot pairs them, so
    the coefficients are the JAX package's bit for bit."""
    v = v.float()
    return torch.stack(
        [(float(m[k, 0]) * v[..., 0] + float(m[k, 1]) * v[..., 1]) + (float(m[k, 2]) * v[..., 2] + float(m[k, 3]) * v[..., 3])
         for k in range(4)],
        dim=-1,
    )


def haar_forward_2d(x: torch.Tensor) -> torch.Tensor:
    """NHWC ``[B, H, W, C]`` -> ``[B, H/2, W/2, 4C]``, channels ``4c..4c+3``
    holding input channel c's bands in the order ``[LH, LL, HL, HH]``;
    computed in float32, returned in x's dtype."""
    B, H, W, C = x.shape
    p = x.reshape(B, H // 2, 2, W // 2, 2, C)
    # the patch vector [tl, tr, bl, br] of each (h', w', c)
    patch = torch.stack([p[:, :, 0, :, 0], p[:, :, 0, :, 1], p[:, :, 1, :, 0], p[:, :, 1, :, 1]], dim=-1)
    return _mix(patch, _H).to(x.dtype).reshape(B, H // 2, W // 2, 4 * C)


def haar_inverse_2d(z: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`haar_forward_2d`."""
    B, Hh, Wh, C4 = z.shape
    C = C4 // 4
    patch = _mix(z.reshape(B, Hh, Wh, C, 4), _H.T).to(z.dtype)
    p = patch.reshape(B, Hh, Wh, C, 2, 2)  # [.., row, col] = [[tl, tr], [bl, br]]
    return p.permute(0, 1, 4, 2, 5, 3).reshape(B, Hh * 2, Wh * 2, C)


def _permutation(c4: int, forward: bool) -> np.ndarray:
    C = c4 // 4
    k_of_i = (1, 0, 2, 3)
    perm = np.zeros(c4, dtype=np.int64)
    for i in range(4):
        k = k_of_i[i]
        for j in range(C):
            if forward:  # band-major out[C*k + j] = channel-major in[4j + i]
                perm[C * k + j] = 4 * j + i
            else:
                perm[4 * j + k] = C * i + j
    return perm


def permute_channels(z: torch.Tensor, forward: bool = True) -> torch.Tensor:
    """Channel-major <-> band-major over the last axis of ``z`` (``4C``
    channels), with bands 0 and 1 swapped."""
    return z[..., torch.from_numpy(_permutation(z.shape[-1], forward)).to(z.device)]


def haar_forward(x: torch.Tensor) -> torch.Tensor:
    """Band-major Haar coefficients ``[approx (C) | details (3C)]``."""
    return permute_channels(haar_forward_2d(x), forward=True)


def haar_backward(z: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`haar_forward`."""
    return haar_inverse_2d(permute_channels(z, forward=False))


def get_dc_coefficients(x: torch.Tensor) -> torch.Tensor:
    """The approximation band of ``x``."""
    return haar_forward(x)[..., : x.shape[-1]]


def get_hf_coefficients(x: torch.Tensor) -> torch.Tensor:
    """The three detail bands of ``x``."""
    return haar_forward(x)[..., x.shape[-1] :]


def multi_level_haar_forward(x: torch.Tensor, level: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``level`` repeated decompositions of the approximation band:
    ``(approx, detail of the last level)``."""
    approx, detail = x, None
    C = x.shape[-1]
    for _ in range(int(level)):
        z = haar_forward(approx)
        approx, detail = z[..., :C], z[..., C:]
    return approx, detail
