"""DDPM score-network layers in PyTorch, NHWC (JAX `models/layers.py`).

Activations stay NHWC as in the JAX package: dense layers act on the last
axis, and a conv runs `F.conv2d` on the NCHW view of the NHWC tensor (a
channels-last tensor to cuDNN), so no layout copy is made between layers.
The convs, GroupNorms and the DDPM resblock also take volumes, NDHWC, with
``dim=3`` (JAX ``dim``; `models/ddpm3d.py`): `F.conv3d` on the NCDHW view,
a 3x3x3 kernel; the kernels of `ops` stay 2-D, and every gate refuses a
3-D call.

Every module keeps the JAX module's name and its parameters' names map
one to one onto the Flax tree (`models/convert.py`): ``kernel`` ->
``weight`` (conv OIHW, dense (out, in)), GroupNorm ``scale`` -> ``weight``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv3x3 import conv3x3
from ..ops.fused_block import resblock_fused, resblock_fused_split
from ..ops.fused_tail import conv3x3_nhwc, group_norm_stats, gn_silu_conv3x3


def default_init_(weight: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """DDPM initialization: variance scaling, fan_avg, uniform (JAX
    `default_init`).  ``weight`` in PyTorch layout (conv OIHW, dense
    (out, in))."""
    scale = 1e-10 if scale == 0 else scale
    receptive = math.prod(weight.shape[2:])
    fan_in, fan_out = weight.shape[1] * receptive, weight.shape[0] * receptive
    limit = math.sqrt(3.0 * scale / ((fan_in + fan_out) / 2.0))
    with torch.no_grad():
        return weight.uniform_(-limit, limit)


def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int, max_positions: int = 10000):
    """Transformer sinusoidal embedding, float32."""
    if timesteps.ndim != 1:
        raise ValueError("timesteps must be 1-D")
    half_dim = embedding_dim // 2
    emb = math.log(max_positions) / (half_dim - 1)
    emb = torch.exp(torch.arange(half_dim, dtype=torch.float32, device=timesteps.device) * -emb)
    emb = timesteps.float()[:, None] * emb[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def fused_tail_candidate_policy(h_shape, out_ch: int) -> bool:
    """The JAX gate of the fused tail: the low-resolution levels, H*W <= 400.
    Kept as it is so the port fires its kernel where the JAX package fires
    Pallas."""
    B, H, W, C = h_shape
    return H * W <= 400


def fused_block_candidate_policy(h_shape, out_ch: int) -> bool:
    """The JAX gate of the whole-resblock kernels: 10x10 and smaller,
    max(H, W) <= 10.  Kept as it is, as the tail gate is."""
    B, H, W, C = h_shape
    return max(H, W) <= 10


def carries_grad(*tensors) -> bool:
    """Whether a gradient must flow through a call on ``tensors`` (grad mode
    on and one of them requires it): the kernels have no backward, so such
    a call takes the plain version, as `ops/upfirdn.py` does for the FIR."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def fused_block_applicable(x, act, train: bool, skip, out_ch: int, enabled: bool, dim: int = 2) -> bool:
    """Gate of the block kernel (JAX `fused_block_applicable`): on, eval,
    2-D, no skip, SiLU, and the shape gate on ``x``; and no gradient
    through ``x`` (`carries_grad`)."""
    return (
        enabled
        and dim == 2
        and not train
        and not carries_grad(x)
        and skip is None
        and act is F.silu
        and fused_block_candidate_policy(x.shape, out_ch)
    )


def fused_split_block_applicable(x, skip, act, train: bool, out_ch: int, enabled: bool, dim: int = 2) -> bool:
    """Gate of the split kernel (JAX `fused_split_block_applicable`): the
    same on the shape of the concat cat(x, skip)."""
    if not enabled or dim != 2 or train or skip is None or act is not F.silu or carries_grad(x, skip):
        return False
    concat_shape = tuple(x.shape[:-1]) + (x.shape[-1] + skip.shape[-1],)
    return fused_block_candidate_policy(concat_shape, out_ch)


#: The conv lowerings a recipe can name (``config.model.conv_dispatch``;
#: JAX `NAMED_CONV_POLICIES`, `models/layers.py:117-132`).  The JAX names
#: ``lowres_im2col``, ``s2d_highres`` and ``tuned`` are exact-math XLA
#: rewrites for the TPU (`ops/im2col.py`, `ops/space_to_depth.py`); on the
#: port they, like ``none``, mean `F.conv2d` (cuDNN).  ``conv3x3_kernel``
#: sends every 3x3 stride-1 SAME conv, in train and eval mode and on both
#: halves of a split conv, to `ops.conv3x3.conv3x3` (TPU kernel 4, which
#: the JAX package never named a policy for because Mosaic faulted:
#: `ops/conv_pallas.py:17-22`).  Stride-2 downsampling convs keep `F.conv2d`.
CONV_POLICIES = {"none": False, "lowres_im2col": False, "s2d_highres": False, "tuned": False, "conv3x3_kernel": True}


def apply_conv_dispatch(model: nn.Module, name: str = "none") -> nn.Module:
    """Set the conv lowering named ``name`` on every 3x3 conv of ``model``."""
    if name not in CONV_POLICIES:
        raise KeyError(f"unknown conv_dispatch {name!r}; known: {', '.join(CONV_POLICIES)}")
    for m in model.modules():
        if isinstance(m, Conv3x3):
            m.use_kernel = CONV_POLICIES[name] and m.dim == 2 and m.stride == 1 and m.padding == 1
    return model


def legacy_num_groups(ch: int) -> int:
    """DDPM-era GroupNorm(32) with a gcd fallback for tiny channel counts."""
    return 32 if ch % 32 == 0 else math.gcd(ch, 32)


def default_num_groups(ch: int) -> int:
    """NCSN++ GroupNorm groups: min(C // 4, 32)."""
    return min(ch // 4, 32)


class Dense(nn.Module):
    """`nn.Dense` over the last axis with DDPM init."""

    def __init__(self, in_dim: int, out_dim: int, init_scale: float = 1.0):
        super().__init__()
        self.weight = nn.Parameter(default_init_(torch.empty(out_dim, in_dim), init_scale))
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Conv3x3(nn.Module):
    """3x3 conv with DDPM init, NHWC in and out, OIHW weight; with ``dim=3``
    a 3x3x3 conv of NDHWC volumes, OIDHW weight.

    ``use_kernel`` (set by :func:`apply_conv_dispatch`, 2-D, stride 1 and
    padding 1 only): the conv runs on `ops.conv3x3.conv3x3`, bias added in
    float32 in its epilogue; otherwise on `F.conv2d` (`F.conv3d`)."""

    def __init__(
        self, in_ch: int, out_ch: int, init_scale: float = 1.0, stride: int = 1, padding: int = 1, dim: int = 2
    ):
        super().__init__()
        self.weight = nn.Parameter(default_init_(torch.empty(out_ch, in_ch, *(3,) * dim), init_scale))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.stride, self.padding, self.dim = stride, padding, dim
        self.use_kernel = False

    def conv(self, x, w, bias=None):
        """The 3x3 conv of NHWC ``x`` with ``w`` (already in x's dtype) and
        an optional float32 ``bias``, by the chosen lowering."""
        if self.use_kernel:
            return conv3x3(x.contiguous(), w, bias)
        bias = None if bias is None else bias.to(x.dtype)
        if self.dim == 3:
            y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, bias, stride=self.stride, padding=self.padding)
            return y.permute(0, 2, 3, 4, 1)
        return conv3x3_nhwc(x, w, bias, self.stride, self.padding)

    def forward(self, x):
        return self.conv(x, self.weight.to(x.dtype), self.bias.float())


class NIN(nn.Module):
    """Network-in-network: a dense layer over the channel axis (param
    ``dense``)."""

    def __init__(self, in_dim: int, num_units: int, init_scale: float = 0.1):
        super().__init__()
        self.dense = Dense(in_dim, num_units, init_scale)

    def forward(self, x):
        return self.dense(x)

    def channel_mix(self):
        """The (out, in) matrix and the bias this layer applies per pixel."""
        return self.dense.weight, self.dense.bias


class Conv1x1(nn.Module):
    """1x1 conv with DDPM init, NHWC in and out, OIHW weight: a per-pixel
    channel mix (``F.linear`` over the last axis)."""

    def __init__(self, in_ch: int, out_ch: int, init_scale: float = 1.0):
        super().__init__()
        self.weight = nn.Parameter(default_init_(torch.empty(out_ch, in_ch, 1, 1), init_scale))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x):
        return F.linear(x, self.weight.flatten(1).to(x.dtype), self.bias.to(x.dtype))

    def channel_mix(self):
        """The (out, in) matrix and the bias this layer applies per pixel."""
        return self.weight.flatten(1), self.bias


def per_pixel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (B, C) tensor as (B, 1, ..., 1, C), to broadcast over ``x``'s
    spatial axes."""
    return v.reshape(v.shape[:1] + (1,) * (x.ndim - 2) + v.shape[1:])


class GroupNorm(nn.Module):
    """GroupNorm over the last axis of NHWC (or NDHWC) data, statistics in
    float32."""

    def __init__(self, num_channels: int, num_groups: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        mean, rstd = group_norm_stats(x, self.num_groups, self.eps)
        scale = rstd * self.weight
        shift = self.bias - mean * scale
        return torch.addcmul(per_pixel(shift, x), x, per_pixel(scale, x)).to(x.dtype)


def legacy_group_norm(ch: int) -> GroupNorm:
    """DDPM-era GroupNorm: 32 groups (gcd fallback), eps 1e-6."""
    return GroupNorm(ch, legacy_num_groups(ch))


class SplitGroupNorm(GroupNorm):
    """GroupNorm over cat(a, b) without making the concat.  Group statistics
    come from per-channel partial moments of each half (one-pass mean and
    mean of squares, as the JAX module).  Returns the two normalized halves."""

    def forward(self, a, b):
        ca, c = a.shape[-1], a.shape[-1] + b.shape[-1]
        g = self.num_groups
        gs = c // g
        n = float(math.prod(a.shape[1:-1]) * gs)
        spatial = tuple(range(1, a.ndim - 1))

        def moments(x):
            xf = x.float()
            return xf.sum(dim=spatial), (xf * xf).sum(dim=spatial)  # (B, Cx)

        sa, qa = moments(a)
        sb, qb = moments(b)
        s = torch.cat([sa, sb], -1).reshape(sa.shape[0], g, gs).sum(-1)
        q = torch.cat([qa, qb], -1).reshape(sa.shape[0], g, gs).sum(-1)
        mu = s / n
        var = q / n - mu * mu
        inv = torch.rsqrt(var + self.eps)
        mu_c = per_pixel(mu.repeat_interleave(gs, dim=-1), a)
        inv_c = per_pixel(inv.repeat_interleave(gs, dim=-1), a)

        def norm(x, lo, hi):
            y = (x.float() - mu_c[..., lo:hi]) * inv_c[..., lo:hi] * self.weight[lo:hi] + self.bias[lo:hi]
            return y.to(x.dtype)

        return norm(a, 0, ca), norm(b, ca, c)


class SplitConv3x3(Conv3x3):
    """3x3 conv over cat(a, b): ``conv(a, W[:, :Ca]) + conv(b, W[:, Ca:])``."""

    def forward(self, a, b):
        ca = a.shape[-1]
        w = self.weight.to(a.dtype)
        out = self.conv(a, w[:, :ca]) + self.conv(b, w[:, ca:])
        return out + self.bias.to(a.dtype)


class SplitConv1x1(Conv1x1):
    """1x1 conv over cat(a, b) as two channel mixes and an add."""

    def forward(self, a, b):
        ca = a.shape[-1]
        w = self.weight.flatten(1).to(a.dtype)
        return F.linear(a, w[:, :ca]) + F.linear(b, w[:, ca:], self.bias.to(a.dtype))


class SplitNIN(NIN):
    """`NIN` over cat(a, b) as two matmuls and an add."""

    def forward(self, a, b):
        ca = a.shape[-1]
        w = self.dense.weight.to(a.dtype)
        return F.linear(a, w[:, :ca]) + F.linear(b, w[:, ca:], self.dense.bias.to(a.dtype))


def spatial_attention(q, k, v):
    """Self-attention over pixels of NHWC q, k, v (contracted over
    channels), in float32 whatever their dtype; out in q's dtype."""
    B, H, W, C = q.shape
    dtype = q.dtype
    q, k, v = (t.reshape(B, H * W, C).float() for t in (q, k, v))
    w = torch.softmax(torch.bmm(q, k.transpose(1, 2)) * (int(C) ** (-0.5)), dim=-1)
    return torch.bmm(w, v).to(dtype).reshape(B, H, W, C)


class AttnBlock(nn.Module):
    """DDPM self-attention over pixels (contracted over channels)."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = legacy_group_norm(channels)
        self.q = NIN(channels, channels)
        self.k = NIN(channels, channels)
        self.v = NIN(channels, channels)
        self.out = NIN(channels, channels, init_scale=0.0)

    def forward(self, x):
        h = self.norm(x)
        return x + self.out(spatial_attention(self.q(h), self.k(h), self.v(h)))


class Upsample(nn.Module):
    """Nearest x2 upsample and an optional conv."""

    def __init__(self, channels: int, with_conv: bool = False):
        super().__init__()
        self.conv = Conv3x3(channels, channels) if with_conv else None

    def forward(self, x):
        h = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest").permute(0, 2, 3, 1)
        return self.conv(h) if self.conv is not None else h


class Downsample(nn.Module):
    """Stride-2 conv after an asymmetric (0, 1) pad, or 2x2 average pool."""

    def __init__(self, channels: int, with_conv: bool = False):
        super().__init__()
        self.conv = Conv3x3(channels, channels, stride=2, padding=0) if with_conv else None

    def forward(self, x):
        if self.conv is not None:
            return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))
        return F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


# 1/sqrt(2) as a Python float, so a bfloat16 activation stays bfloat16.
INV_SQRT2 = float(1.0 / math.sqrt(2.0))


class FusedResblock(nn.Module):
    """What the DDPM and NCSN++ resblocks share: the norm1 -> act -> dropout
    -> conv1 tail, which `ops.fused_tail.gn_silu_conv3x3` computes in eval
    mode, on a call that carries no gradient (:func:`carries_grad`), where
    the JAX gate :func:`fused_tail_candidate_policy` holds and the
    activation is SiLU (``fused_tail``), and the whole block, which
    `ops.fused_block.resblock_fused` (no skip) or `resblock_fused_split` (on
    cat(x, skip)) computes in eval mode where
    :func:`fused_block_candidate_policy` holds and the activation is SiLU
    (``fused_block``); there it wins over the tail.  The parameters are the
    unfused block's.

    A subclass sets ``act``, ``out_ch``, ``fused_tail``, ``fused_block``,
    ``skip_rescale`` and the modules ``norm0``, ``conv0``, ``temb_proj``,
    ``norm1``, ``dropout``, ``conv1`` and ``shortcut`` (None, or a layer with
    ``channel_mix()``).  A 3-D block (``dim`` 3) takes no kernel, as in JAX.
    """

    dim = 2

    def gn_act_conv_tail(self, h):
        """The norm1 -> act -> dropout -> conv1 tail."""
        if (
            self.fused_tail
            and self.dim == 2
            and not self.training
            and not carries_grad(h)
            and self.act is F.silu
            and fused_tail_candidate_policy(h.shape, self.out_ch)
        ):
            # the kernel takes its vectors in float32, whatever the compute dtype
            return gn_silu_conv3x3(
                h.contiguous(),
                self.conv1.weight.to(h.dtype),
                self.norm1.weight.float(),
                self.norm1.bias.float(),
                self.norm1.num_groups,
                bias=self.conv1.bias.float(),
            )
        h = self.dropout(self.act(self.norm1(h)))
        return self.conv1(h)

    def fused_block_args(self, dtype, temb) -> dict:
        """The block's parameters as the whole-block kernels take them:
        weights in the compute ``dtype``, vectors and the temb projection
        (computed here, as in JAX) in float32, the shortcut (NIN or 1x1
        conv) as a (Cin, Cout) matrix: the transposed view of its (Cout, Cin)
        weight, which the kernel packs once per weight."""
        ws = bs = None
        if self.shortcut is not None:
            w, b = self.shortcut.channel_mix()
            ws, bs = w.t().to(dtype), b.float()
        return dict(
            gamma0=self.norm0.weight.float(), beta0=self.norm0.bias.float(),
            num_groups0=self.norm0.num_groups,
            w0=self.conv0.weight.to(dtype), b0=self.conv0.bias.float(),
            temb_proj=None if temb is None else self.temb_proj(self.act(temb)).float(),
            gamma1=self.norm1.weight.float(), beta1=self.norm1.bias.float(),
            num_groups1=self.norm1.num_groups,
            w1=self.conv1.weight.to(dtype), b1=self.conv1.bias.float(),
            shortcut_w=ws, shortcut_b=bs, skip_rescale=self.skip_rescale,
        )

    def fused_whole_block(self, x, temb, skip) -> Optional[torch.Tensor]:
        """The block as one kernel call where its gate holds, else None."""
        if fused_block_applicable(x, self.act, self.training, skip, self.out_ch, self.fused_block, self.dim):
            return resblock_fused(x.contiguous(), **self.fused_block_args(x.dtype, temb))
        if fused_split_block_applicable(x, skip, self.act, self.training, self.out_ch, self.fused_block, self.dim):
            return resblock_fused_split(x.contiguous(), skip.contiguous(), **self.fused_block_args(x.dtype, temb))
        return None

    def residual(self, x, h):
        """``x + h``, times 1/sqrt(2) with ``skip_rescale``."""
        return (x + h) * INV_SQRT2 if self.skip_rescale else x + h


class ResnetBlockDDPM(FusedResblock):
    """DDPM ResNet block, 2-D or, with ``dim=3``, 3-D (NDHWC); with
    ``num_groups=default_num_groups``, the conv1 ``init_scale`` and
    ``skip_rescale`` it is the NCSN++ DDPM block.

    ``split_skip``: when a ``skip`` tensor is passed, compute the block on
    the virtual concatenation cat(x, skip) (SplitGroupNorm, SplitConv3x3,
    SplitNIN), with the same parameters as the joint block.

    ``fused_tail``, ``fused_block``: see :class:`FusedResblock`; the whole
    block fuses where the shortcut is the identity or the NIN (JAX
    `ResnetBlockDDPM`).
    """

    def __init__(
        self,
        act: Callable,
        in_ch: int,
        out_ch: Optional[int] = None,
        temb_dim: Optional[int] = None,
        conv_shortcut: bool = False,
        dropout: float = 0.1,
        split_skip: bool = False,
        fused_tail: bool = False,
        fused_block: bool = False,
        num_groups: Callable[[int], int] = legacy_num_groups,
        init_scale: float = 0.0,
        skip_rescale: bool = False,
        dim: int = 2,
    ):
        super().__init__()
        out_ch = out_ch if out_ch is not None else in_ch
        self.act, self.in_ch, self.out_ch, self.conv_shortcut = act, in_ch, out_ch, conv_shortcut
        self.split_skip, self.fused_tail, self.fused_block = split_skip, fused_tail, fused_block
        self.skip_rescale, self.dim = skip_rescale, dim
        G_in = num_groups(in_ch)
        self.norm0 = SplitGroupNorm(in_ch, G_in) if split_skip else GroupNorm(in_ch, G_in)
        self.conv0 = (SplitConv3x3 if split_skip else Conv3x3)(in_ch, out_ch, dim=dim)
        self.temb_proj = Dense(temb_dim, out_ch) if temb_dim is not None else None
        self.norm1 = GroupNorm(out_ch, num_groups(out_ch))
        self.dropout = nn.Dropout(dropout)
        self.conv1 = Conv3x3(out_ch, out_ch, init_scale=init_scale, dim=dim)
        if in_ch != out_ch:
            if conv_shortcut:
                self.shortcut = (SplitConv3x3 if split_skip else Conv3x3)(in_ch, out_ch, dim=dim)
            else:
                self.shortcut = (SplitNIN if split_skip else NIN)(in_ch, out_ch)
        else:
            self.shortcut = None

    def forward(self, x, temb=None, skip=None):
        if skip is not None and not self.split_skip:
            x = torch.cat([x, skip], dim=-1)
            skip = None
        if self.in_ch == self.out_ch or not self.conv_shortcut:
            fused = self.fused_whole_block(x, temb, skip)
            if fused is not None:
                return fused
        if skip is None:
            h = self.conv0(self.act(self.norm0(x)))
        else:
            na, nb = self.norm0(x, skip)
            h = self.conv0(self.act(na), self.act(nb))
        if temb is not None:
            h = h + per_pixel(self.temb_proj(self.act(temb)), h)
        h = self.gn_act_conv_tail(h)
        if self.shortcut is not None:
            x = self.shortcut(x, skip) if skip is not None else self.shortcut(x)
        elif skip is not None:  # identity residual needs the real concat
            x = torch.cat([x, skip], dim=-1)
        return self.residual(x, h)
