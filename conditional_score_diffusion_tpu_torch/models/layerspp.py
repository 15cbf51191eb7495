"""NCSN++ building blocks in PyTorch, NHWC (JAX `models/layerspp.py`):
`GaussianFourierProjection`, `Combine`, `AttnBlockpp`, the FIR `Upsample`
and `Downsample`, `ResnetBlockDDPMpp` and `ResnetBlockBigGANpp`.

Module and parameter names are the Flax ones (`models/convert.py` maps the
leaves): the Fourier projection's frozen ``W`` is a buffer; the fused
FIR-conv resamplers hold ``conv_w`` (OIHW here, HWIO in Flax) and ``conv_b``.
The FIR resampling at factor 2 goes through `ops/fir.py` (a CUDA kernel on
the card).  The resblocks take the tail and whole-block kernels as the DDPM
block does (`layers.FusedResblock`), the BigGAN block with its 1x1-conv
shortcut as the kernels' (Cin, Cout) matrix and ``skip_rescale``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.upfirdn import (
    conv_downsample_2d,
    downsample_2d,
    naive_downsample_2d,
    naive_upsample_2d,
    upsample_2d,
    upsample_conv_2d,
)
from .layers import (
    INV_SQRT2,
    NIN,
    Conv1x1,
    Conv3x3,
    Dense,
    FusedResblock,
    GroupNorm,
    ResnetBlockDDPM,
    SplitConv1x1,
    SplitConv3x3,
    SplitGroupNorm,
    default_init_,
    default_num_groups,
    spatial_attention,
)


def group_norm(ch: int) -> GroupNorm:
    """GroupNorm with the NCSN++ groups, eps 1e-6."""
    return GroupNorm(ch, default_num_groups(ch))


class GaussianFourierProjection(nn.Module):
    """Gaussian Fourier features of the noise level; ``W`` ~ N(0, scale^2)
    is frozen (a buffer)."""

    def __init__(self, embedding_size: int = 256, scale: float = 1.0):
        super().__init__()
        self.register_buffer("W", torch.randn(embedding_size) * scale)

    def forward(self, x):
        # left to right as in JAX: labels reach 999 and W*2*pi folded first
        # would round the ~1e5 rad phase otherwise
        x_proj = x[:, None] * self.W[None, :] * 2 * math.pi
        return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], dim=-1)


class Combine(nn.Module):
    """Combine a progressive-input pyramid level with features: a 1x1 conv
    of the pyramid (param ``conv``), then concat or sum."""

    def __init__(self, in_ch: int, out_ch: int, method: str = "cat"):
        super().__init__()
        if method not in ("cat", "sum"):
            raise ValueError(f"combine method {method!r} not recognized")
        self.conv = Conv1x1(in_ch, out_ch)
        self.method = method

    def forward(self, x, y):
        h = self.conv(x)
        return torch.cat([h, y], dim=-1) if self.method == "cat" else h + y


class AttnBlockpp(nn.Module):
    """NCSN++ self-attention over pixels, with the optional 1/sqrt(2) skip
    rescale."""

    def __init__(self, channels: int, skip_rescale: bool = False, init_scale: float = 0.0):
        super().__init__()
        self.norm = group_norm(channels)
        self.q = NIN(channels, channels)
        self.k = NIN(channels, channels)
        self.v = NIN(channels, channels)
        self.out = NIN(channels, channels, init_scale=init_scale)
        self.skip_rescale = skip_rescale

    def forward(self, x):
        h = self.norm(x)
        h = self.out(spatial_attention(self.q(h), self.k(h), self.v(h)))
        return (x + h) * INV_SQRT2 if self.skip_rescale else x + h


class _Resample(nn.Module):
    """Parameters of a x2 resampler: a 3x3 conv ``conv`` (nearest / average
    pool paths) or the fused FIR-conv's ``conv_w``/``conv_b``."""

    def __init__(self, in_ch: int, out_ch: int, with_conv: bool, fir: bool, fir_kernel: Sequence[float], **conv_kw):
        super().__init__()
        self.with_conv, self.fir, self.fir_kernel = with_conv, fir, tuple(fir_kernel)
        self.conv = Conv3x3(in_ch, out_ch, **conv_kw) if with_conv and not fir else None
        if with_conv and fir:
            self.conv_w = nn.Parameter(default_init_(torch.empty(out_ch, in_ch, 3, 3)))
            self.conv_b = nn.Parameter(torch.zeros(out_ch))


class Upsample(_Resample):
    """x2 upsample: nearest (+ conv), FIR, or the fused FIR upsample-conv."""

    def __init__(self, in_ch: int, out_ch: int, with_conv: bool = False, fir: bool = False, fir_kernel=(1, 3, 3, 1)):
        super().__init__(in_ch, out_ch, with_conv, fir, fir_kernel)

    def forward(self, x):
        if not self.fir:
            h = naive_upsample_2d(x, 2)
            return self.conv(h) if self.conv is not None else h
        if not self.with_conv:
            return upsample_2d(x, self.fir_kernel, factor=2)
        return upsample_conv_2d(x, self.conv_w, k=self.fir_kernel) + self.conv_b.to(x.dtype)


class Downsample(_Resample):
    """x2 downsample: stride-2 conv after a (0, 1) pad or average pool, FIR,
    or the fused FIR conv-downsample."""

    def __init__(self, in_ch: int, out_ch: int, with_conv: bool = False, fir: bool = False, fir_kernel=(1, 3, 3, 1)):
        super().__init__(in_ch, out_ch, with_conv, fir, fir_kernel, stride=2, padding=0)

    def forward(self, x):
        if not self.fir:
            if self.conv is not None:
                return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))
            return naive_downsample_2d(x, 2)
        if not self.with_conv:
            return downsample_2d(x, self.fir_kernel, factor=2)
        return conv_downsample_2d(x, self.conv_w, k=self.fir_kernel) + self.conv_b.to(x.dtype)


class ResnetBlockDDPMpp(ResnetBlockDDPM):
    """DDPM-style NCSN++ resblock: the DDPM block with NCSN++ groups, the
    conv1 ``init_scale`` and ``skip_rescale``."""

    def __init__(
        self,
        act: Callable,
        in_ch: int,
        out_ch: Optional[int] = None,
        temb_dim: Optional[int] = None,
        conv_shortcut: bool = False,
        dropout: float = 0.1,
        skip_rescale: bool = False,
        init_scale: float = 0.0,
        split_skip: bool = False,
        fused_tail: bool = False,
        fused_block: bool = False,
    ):
        super().__init__(
            act, in_ch, out_ch, temb_dim=temb_dim, conv_shortcut=conv_shortcut, dropout=dropout,
            split_skip=split_skip, fused_tail=fused_tail, fused_block=fused_block,
            num_groups=default_num_groups, init_scale=init_scale, skip_rescale=skip_rescale,
        )


class ResnetBlockBigGANpp(FusedResblock):
    """BigGAN-style NCSN++ resblock, with the x2 up or down resampling of
    both paths inside the block (FIR or nearest / mean pool) and a 1x1-conv
    shortcut wherever the shape changes.

    ``split_skip`` (decoder blocks without resampling): the block on the
    virtual concat cat(x, skip).  ``fused_tail``, ``fused_block``: see
    `layers.FusedResblock`; the whole block fuses only without resampling.
    """

    def __init__(
        self,
        act: Callable,
        in_ch: int,
        out_ch: Optional[int] = None,
        temb_dim: Optional[int] = None,
        up: bool = False,
        down: bool = False,
        dropout: float = 0.1,
        fir: bool = False,
        fir_kernel: Sequence[float] = (1, 3, 3, 1),
        skip_rescale: bool = True,
        init_scale: float = 0.0,
        split_skip: bool = False,
        fused_tail: bool = False,
        fused_block: bool = False,
    ):
        super().__init__()
        out_ch = out_ch if out_ch is not None else in_ch
        self.act, self.in_ch, self.out_ch, self.up, self.down = act, in_ch, out_ch, up, down
        self.fir, self.fir_kernel, self.skip_rescale = fir, tuple(fir_kernel), skip_rescale
        self.split_skip = split_skip and not up and not down
        self.fused_tail, self.fused_block = fused_tail, fused_block
        G_in = default_num_groups(in_ch)
        self.norm0 = SplitGroupNorm(in_ch, G_in) if self.split_skip else GroupNorm(in_ch, G_in)
        self.conv0 = (SplitConv3x3 if self.split_skip else Conv3x3)(in_ch, out_ch)
        self.temb_proj = Dense(temb_dim, out_ch) if temb_dim is not None else None
        self.norm1 = group_norm(out_ch)
        self.dropout = nn.Dropout(dropout)
        self.conv1 = Conv3x3(out_ch, out_ch, init_scale=init_scale)
        if in_ch != out_ch or up or down:
            self.shortcut = (SplitConv1x1 if self.split_skip else Conv1x1)(in_ch, out_ch)
        else:
            self.shortcut = None

    def resample(self, t):
        if self.up:
            return upsample_2d(t, self.fir_kernel, factor=2) if self.fir else naive_upsample_2d(t, 2)
        if self.down:
            return downsample_2d(t, self.fir_kernel, factor=2) if self.fir else naive_downsample_2d(t, 2)
        return t

    def forward(self, x, temb=None, skip=None):
        if skip is not None and not self.split_skip:
            x = torch.cat([x, skip], dim=-1)
            skip = None
        if not self.up and not self.down:
            fused = self.fused_whole_block(x, temb, skip)
            if fused is not None:
                return fused
        if skip is None:
            h = self.conv0(self.resample(self.act(self.norm0(x))))
            x = self.resample(x)
        else:
            na, nb = self.norm0(x, skip)
            h = self.conv0(self.act(na), self.act(nb))
        if temb is not None:
            h = h + self.temb_proj(self.act(temb))[:, None, None, :]
        h = self.gn_act_conv_tail(h)
        if self.shortcut is not None:
            x = self.shortcut(x, skip) if skip is not None else self.shortcut(x)
        elif skip is not None:  # identity residual needs the real concat
            x = torch.cat([x, skip], dim=-1)
        return self.residual(x, h)
