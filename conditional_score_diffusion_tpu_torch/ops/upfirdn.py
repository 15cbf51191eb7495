"""upfirdn2d and the StyleGAN2-style FIR resampling of NCSN++, NHWC, in plain
PyTorch (the JAX package's `ops/upfirdn.py`).

`upfirdn2d` is zero-stuff upsample -> pad -> convolve with the kernel ->
stride-slice downsample, as the JAX package's one lhs-dilated depthwise conv
computes it; here it is a depthwise `F.conv2d` (correlation with the flipped
kernel) on the NCHW view, summed in float32 and rounded to ``x.dtype`` once.

`upsample_2d` and `downsample_2d` at factor 2 with a 4-tap 1-D kernel (every
recipe's [1, 3, 3, 1]) and gain 1 are the two TPU kernels
`fir_upsample2` / `fir_downsample2`: where no gradient has to flow through
the call, they go through `ops/fir.py`, which launches the CUDA kernel for a
CUDA tensor and comes back here for a CPU one.  Where one does (grad mode on
and ``x`` requiring grad: an NCSN++ with ``fir=True`` in training), they take
the plain versions here, which autograd differentiates as JAX's autodiff
does its `upfirdn2d`; the kernels have no backward.  Every other factor,
kernel and gain stays in this module.

Conv weights ``w`` are OIHW (PyTorch's layout; the JAX functions take HWIO).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

Kernel = Union[Sequence[float], np.ndarray]


def setup_kernel(k: Kernel, gain: float = 1.0) -> np.ndarray:
    """A FIR kernel normalised to sum 1, times ``gain``; a 1-D kernel becomes
    the separable 2-D one (outer product)."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    k = k / np.sum(k)
    if k.ndim != 2 or k.shape[0] != k.shape[1]:
        raise ValueError(f"FIR kernel must be square, got shape {k.shape}")
    return k * gain


def upfirdn2d(x: torch.Tensor, kernel: Kernel, up: int = 1, down: int = 1, pad=(0, 0)) -> torch.Tensor:
    """Upsample (zero-stuff) -> pad -> FIR filter -> downsample of NHWC ``x``.

    ``kernel`` is the 2-D tap (already gain-scaled) or a 1-D one (made
    separable); ``pad`` = (before, after) on both spatial axes after the
    upsample; a negative pad crops.
    """
    k = np.asarray(kernel, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    lo, hi = (int(p) for p in pad)
    B, H, W, C = x.shape
    h = x.permute(0, 3, 1, 2).float()
    if up > 1:
        h = h.reshape(B, C, H, 1, W, 1)
        h = F.pad(h, (0, up - 1, 0, 0, 0, up - 1)).reshape(B, C, H * up, W * up)
    h = F.pad(h, (max(lo, 0), max(hi, 0), max(lo, 0), max(hi, 0)))
    h = h[:, :, max(-lo, 0) : h.shape[2] - max(-hi, 0), max(-lo, 0) : h.shape[3] - max(-hi, 0)]
    w = torch.from_numpy(np.ascontiguousarray(k[::-1, ::-1])).to(h.device)
    w = w[None, None].expand(C, 1, *k.shape).contiguous()
    h = F.conv2d(h, w, stride=down, groups=C)
    return h.permute(0, 2, 3, 1).to(x.dtype)


def _routes_to_fir2(x: torch.Tensor, k: Optional[Kernel], factor: int, gain: float) -> bool:
    """Whether `ops/fir.py`'s factor-2 kernels compute this resampling: they
    take it, and no gradient has to flow through it."""
    if torch.is_grad_enabled() and x.requires_grad:
        return False
    return factor == 2 and gain == 1.0 and k is not None and np.asarray(k).shape == (4,)


def upsample_2d(x: torch.Tensor, k: Optional[Kernel] = None, factor: int = 2, gain: float = 1.0):
    """FIR upsample of NHWC ``x`` by ``factor``."""
    if factor < 1:
        raise ValueError(f"factor must be >= 1, got {factor}")
    if _routes_to_fir2(x, k, factor, gain):
        from .fir import fir_upsample2

        return fir_upsample2(x.contiguous(), tuple(float(v) for v in k))
    return upsample_2d_plain(x, k, factor, gain)


def upsample_2d_plain(x: torch.Tensor, k: Optional[Kernel] = None, factor: int = 2, gain: float = 1.0):
    """:func:`upsample_2d` through :func:`upfirdn2d` alone, on any device."""
    kernel = setup_kernel([1] * factor if k is None else k, gain * (factor**2))
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, up=factor, pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample_2d(x: torch.Tensor, k: Optional[Kernel] = None, factor: int = 2, gain: float = 1.0):
    """FIR downsample of NHWC ``x`` by ``factor``."""
    if factor < 1:
        raise ValueError(f"factor must be >= 1, got {factor}")
    if _routes_to_fir2(x, k, factor, gain):
        from .fir import fir_downsample2

        return fir_downsample2(x.contiguous(), tuple(float(v) for v in k))
    return downsample_2d_plain(x, k, factor, gain)


def downsample_2d_plain(x: torch.Tensor, k: Optional[Kernel] = None, factor: int = 2, gain: float = 1.0):
    """:func:`downsample_2d` through :func:`upfirdn2d` alone, on any device."""
    kernel = setup_kernel([1] * factor if k is None else k, gain)
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, down=factor, pad=((p + 1) // 2, p // 2))


def upsample_conv_2d(x: torch.Tensor, w: torch.Tensor, k: Optional[Kernel] = None, factor: int = 2, gain: float = 1.0):
    """Upsample and conv (OIHW ``w``) fused as in the JAX package: a
    stride-``factor`` transposed conv (zero-stuffed ``x`` correlated with
    ``w`` under full padding), then the FIR filter."""
    kh, kw = w.shape[2:]
    if kh != kw:
        raise ValueError(f"conv kernel must be square, got {tuple(w.shape)}")
    kernel = setup_kernel([1] * factor if k is None else k, gain * (factor**2))
    p = (kernel.shape[0] - factor) - (kw - 1)
    B, H, W, C = x.shape
    h = x.permute(0, 3, 1, 2).reshape(B, C, H, 1, W, 1)
    h = F.pad(h, (0, factor - 1, 0, 0, 0, factor - 1)).reshape(B, C, H * factor, W * factor)
    h = h[:, :, : H * factor - (factor - 1), : W * factor - (factor - 1)]  # the lhs dilation's length
    y = F.conv2d(h, w.to(x.dtype), padding=kh - 1).permute(0, 2, 3, 1)
    return upfirdn2d(y, kernel, pad=((p + 1) // 2 + factor - 1, p // 2 + 1))


def conv_downsample_2d(x: torch.Tensor, w: torch.Tensor, k: Optional[Kernel] = None, factor: int = 2, gain: float = 1.0):
    """FIR filter, then a stride-``factor`` VALID conv with OIHW ``w``."""
    kh, kw = w.shape[2:]
    if kh != kw:
        raise ValueError(f"conv kernel must be square, got {tuple(w.shape)}")
    kernel = setup_kernel([1] * factor if k is None else k, gain)
    p = (kernel.shape[0] - factor) + (kw - 1)
    y = upfirdn2d(x, kernel, pad=((p + 1) // 2, p // 2))
    return F.conv2d(y.permute(0, 3, 1, 2), w.to(x.dtype), stride=factor).permute(0, 2, 3, 1)


def naive_upsample_2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample of NHWC ``x``."""
    return x.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)


def naive_downsample_2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Mean-pool downsample of NHWC ``x``."""
    B, H, W, C = x.shape
    return x.reshape(B, H // factor, factor, W // factor, factor, C).mean(dim=(2, 4))
