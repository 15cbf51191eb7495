"""NCSN and NCSNv2: RefineNet score networks, NHWC (JAX `models/ncsnv2.py`).

Registered as ``ncsn`` (conditional InstanceNorm++ on the integer noise
class), ``ncsnv2_64``, ``ncsnv2_128`` and ``ncsnv2_256`` (the recipe's
unconditional normalization; ``cond`` is ignored).  Every module carries
the Flax module's name (``begin_conv``, ``res{level}_{block}``,
``refine{k}`` with ``adapt{i}`` / ``msf`` / ``crp`` / ``out``,
``normalizer``, ``end_conv``), so `models/convert.py` maps the parameters
one to one.

The pieces JAX spells out as it does:

* a 3x3 conv pads by its dilation (a 1x1 conv by 0);
* a down-sampling residual block with dilation > 1 does not pool: its
  shortcut is a dilated 3x3 conv, so the dilated levels keep their size;
* the 5x5 stride-1 pools of the chained residual pooling: max pads with
  -inf, the average divides by 25 at the borders too (``count_include_pad``);
* the multi-scale fusion resizes bilinearly with ``align_corners=True``
  (JAX builds the resize as a dense matrix; `F.interpolate` computes the
  same weights);
* `UpsampleConv` repeats each pixel 2x2, then convolves; `ConvMeanPool`
  with ``adjust_padding`` (28px data) pads a row and a column at the top
  left before its conv.

The default init is Flax's: conv kernels LeCun normal, biases 0 (the norms'
own init in `models/normalization.py`), from torch's default generator.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Callable, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import register_model
from .fcn import _TRUNCATED_STD
from .normalization import ConditionalInstanceNorm2dPlus, get_normalization

ACTS = {
    "elu": F.elu,
    "relu": F.relu,
    "lrelu": lambda x: F.leaky_relu(x, 0.2),
    "swish": F.silu,
}


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class NCSNConv(nn.Module):
    """`ncsn_conv`: a ``kernel`` x ``kernel`` conv, stride 1, padded by
    ``dilation`` (3x3) or 0 (1x1), NHWC in and out, OIHW weight."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, bias: bool = True, dilation: int = 1):
        super().__init__()
        weight = torch.empty(out_ch, in_ch, kernel, kernel)
        std = math.sqrt(1.0 / (in_ch * kernel * kernel)) / _TRUNCATED_STD
        self.weight = nn.Parameter(nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.dilation = dilation
        self.padding = dilation if kernel == 3 else 0

    def forward(self, x):
        y = F.conv2d(_nchw(x), self.weight, self.bias, padding=self.padding, dilation=self.dilation)
        return _nhwc(y)


def pool5(x, kind: str):
    """5x5 stride-1 pooling, padded by 2 (NHWC)."""
    if kind == "max":
        return _nhwc(F.max_pool2d(_nchw(x), 5, stride=1, padding=2))
    return _nhwc(F.avg_pool2d(_nchw(x), 5, stride=1, padding=2, count_include_pad=True))


def bilinear_resize_align_corners(x, shape: Sequence[int]):
    """NHWC ``x`` resized to ``shape`` (H, W), bilinear, corners aligned."""
    if tuple(x.shape[1:3]) == tuple(shape):
        return x
    return _nhwc(F.interpolate(_nchw(x), size=tuple(shape), mode="bilinear", align_corners=True))


def mean_pool2(x):
    B, H, W, C = x.shape
    return x.reshape(B, H // 2, 2, W // 2, 2, C).mean(dim=(2, 4))


class ConvMeanPool(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, bias: bool = True, adjust_padding: bool = False):
        super().__init__()
        self.adjust_padding = adjust_padding
        self.conv = NCSNConv(in_ch, out_ch, kernel, bias=bias)

    def forward(self, x):
        if self.adjust_padding:
            x = F.pad(x, (0, 0, 1, 0, 1, 0))
        return mean_pool2(self.conv(x))


class MeanPoolConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, bias: bool = True):
        super().__init__()
        self.conv = NCSNConv(in_ch, out_ch, kernel, bias=bias)

    def forward(self, x):
        return self.conv(mean_pool2(x))


class UpsampleConv(nn.Module):
    """Each pixel repeated 2x2, then the conv."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, bias: bool = True):
        super().__init__()
        self.conv = NCSNConv(in_ch, out_ch, kernel, bias=bias)

    def forward(self, x):
        return self.conv(x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))


class CRPBlock(nn.Module):
    """Chained residual pooling."""

    def __init__(self, features: int, n_stages: int, act: Callable, maxpool: bool = True):
        super().__init__()
        self.act, self.n_stages, self.kind = act, n_stages, "max" if maxpool else "avg"
        for i in range(n_stages):
            self.add_module(f"conv{i}", NCSNConv(features, features, bias=False))

    def forward(self, x):
        x = self.act(x)
        path = x
        for i in range(self.n_stages):
            path = getattr(self, f"conv{i}")(pool5(path, self.kind))
            x = path + x
        return x


class RCUBlock(nn.Module):
    """Residual conv units: ``n_blocks`` of ``n_stages`` (act, conv)."""

    def __init__(self, features: int, n_blocks: int, n_stages: int, act: Callable):
        super().__init__()
        self.act, self.n_blocks, self.n_stages = act, n_blocks, n_stages
        for i in range(n_blocks):
            for j in range(n_stages):
                self.add_module(f"conv_{i}_{j}", NCSNConv(features, features, bias=False))

    def forward(self, x):
        for i in range(self.n_blocks):
            residual = x
            for j in range(self.n_stages):
                x = getattr(self, f"conv_{i}_{j}")(self.act(x))
            x = x + residual
        return x


class MSFBlock(nn.Module):
    """Multi-scale fusion: a conv per input, resized to ``shape``, summed."""

    def __init__(self, in_chs: Sequence[int], features: int):
        super().__init__()
        self.n_inputs = len(in_chs)
        for i, ch in enumerate(in_chs):
            self.add_module(f"conv{i}", NCSNConv(ch, features, bias=True))

    def forward(self, xs, shape):
        out = 0.0
        for i in range(self.n_inputs):
            out = out + bilinear_resize_align_corners(getattr(self, f"conv{i}")(xs[i]), shape)
        return out


class RefineBlock(nn.Module):
    def __init__(self, in_chs: Sequence[int], features: int, act: Callable, end: bool = False, maxpool: bool = True):
        super().__init__()
        self.n_inputs = len(in_chs)
        for i, ch in enumerate(in_chs):
            self.add_module(f"adapt{i}", RCUBlock(ch, 2, 2, act))
        if self.n_inputs > 1:
            self.msf = MSFBlock(in_chs, features)
        self.crp = CRPBlock(features, 2, act, maxpool=maxpool)
        self.out = RCUBlock(features, 3 if end else 1, 2, act)

    def forward(self, xs, shape):
        hs = [getattr(self, f"adapt{i}")(x) for i, x in enumerate(xs)]
        h = self.msf(hs, shape) if self.n_inputs > 1 else hs[0]
        return self.out(self.crp(h))


class ResidualBlock(nn.Module):
    """The NCSNv2 residual block (norm, act, conv) x 2 plus a shortcut."""

    def __init__(self, in_ch: int, out_ch: int, norm: Callable, act: Callable, resample: Optional[str] = None,
                 adjust_padding: bool = False, dilation: int = 1):
        super().__init__()
        self.act = act
        self.norm0 = norm(in_ch)
        self.shortcut = None
        if resample == "down":
            self.conv0 = NCSNConv(in_ch, in_ch, dilation=dilation)
            self.norm1 = norm(in_ch)
            if dilation > 1:
                self.conv1 = NCSNConv(in_ch, out_ch, dilation=dilation)
                self.shortcut = NCSNConv(in_ch, out_ch, dilation=dilation)
            else:
                self.conv1 = ConvMeanPool(in_ch, out_ch, 3, adjust_padding=adjust_padding)
                self.shortcut = ConvMeanPool(in_ch, out_ch, 1, adjust_padding=adjust_padding)
        else:
            self.conv0 = NCSNConv(in_ch, out_ch, dilation=dilation)
            self.norm1 = norm(out_ch)
            self.conv1 = NCSNConv(out_ch, out_ch, dilation=dilation)
            if in_ch != out_ch:
                self.shortcut = NCSNConv(in_ch, out_ch, 3 if dilation > 1 else 1, dilation=dilation)

    def forward(self, x):
        h = self.conv0(self.act(self.norm0(x)))
        h = self.conv1(self.act(self.norm1(h)))
        return (x if self.shortcut is None else self.shortcut(x)) + h


class _NCSNv2Base(nn.Module):
    """The fields of the family and their `from_config` (JAX
    `_NCSNv2Base`)."""

    def __init__(self, nf: int, num_channels: int, num_scales: int, image_size: int, centered: bool,
                 normalization: str, nonlinearity: str):
        super().__init__()
        self.nf, self.num_channels, self.num_scales = nf, num_channels, num_scales
        self.image_size, self.centered = image_size, centered
        self.normalization, self.nonlinearity = normalization, nonlinearity
        self.act = ACTS[nonlinearity]

    @classmethod
    def from_config(cls, config):
        return cls(
            nf=config.model.nf,
            num_channels=config.data.num_channels,
            num_scales=config.model.num_scales,
            image_size=config.data.image_size,
            centered=config.data.centered,
            normalization=config.model.normalization,
            nonlinearity=config.model.nonlinearity.lower(),
        )

    def _input(self, x):
        return x if self.centered else 2 * x - 1.0


class _NCSNv2(_NCSNv2Base):
    """An unconditional RefineNet: residual levels, refine blocks from the
    deepest level up, then norm, act and ``end_conv``."""

    # the residual levels: per level, per block, (out_ch as a multiple of nf, resample, dilation)
    LEVELS: List[List[tuple]] = []
    # the refine blocks from the deepest: (name, features as a multiple of nf)
    REFINES: List[tuple] = []

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        nf, act = self.nf, self.act

        norm = get_normalization(SimpleNamespace(model=SimpleNamespace(normalization=self.normalization)))
        self.begin_conv = NCSNConv(self.num_channels, nf)
        ch, level_chs = nf, []
        for li, blocks in enumerate(self.LEVELS):
            for bi, (mult, resample, dilation) in enumerate(blocks):
                # (ncsnv2_64 passes adjust_padding to its dilated last level, where it has no effect)
                self.add_module(f"res{li}_{bi}", ResidualBlock(ch, mult * nf, norm, act, resample, dilation=dilation))
                ch = mult * nf
            level_chs.append(ch)
        prev = None
        for k, (name, mult) in enumerate(self.REFINES):
            level = len(self.LEVELS) - 1 - k
            in_chs = [level_chs[level]] if prev is None else [level_chs[level], prev]
            self.add_module(name, RefineBlock(in_chs, mult * nf, act, end=k == len(self.REFINES) - 1))
            prev = mult * nf
        self.normalizer = norm(nf)
        self.end_conv = NCSNConv(nf, self.num_channels)

    def forward(self, x, cond=None):
        h = self.begin_conv(self._input(x))
        levels = []
        for li, blocks in enumerate(self.LEVELS):
            for bi in range(len(blocks)):
                h = getattr(self, f"res{li}_{bi}")(h)
            levels.append(h)
        r = None
        for k, (name, _) in enumerate(self.REFINES):
            lvl = levels[len(levels) - 1 - k]
            r = getattr(self, name)([lvl] if r is None else [lvl, r], lvl.shape[1:3])
        return self.end_conv(self.act(self.normalizer(r)))


def _level(mult, resample=None, dilation=1):
    """A level of two blocks: the first may resample, both share dilation."""
    return [(mult, resample, dilation), (mult, None, dilation)]


@register_model(name="ncsnv2_64")
class NCSNv2(_NCSNv2):
    LEVELS = [_level(1), _level(2, "down"), _level(2, "down", 2), _level(2, "down", 4)]
    REFINES = [("refine1", 2), ("refine2", 2), ("refine3", 1), ("refine4", 1)]


@register_model(name="ncsnv2_128")
class NCSNv2_128(_NCSNv2):
    LEVELS = [_level(1), _level(2, "down"), _level(2, "down"), _level(4, "down", 2), _level(4, "down", 4)]
    REFINES = [("refine1", 4), ("refine2", 2), ("refine3", 2), ("refine4", 1), ("refine5", 1)]


@register_model(name="ncsnv2_256")
class NCSNv2_256(_NCSNv2):
    LEVELS = [_level(1), _level(2, "down"), _level(2, "down"), _level(2, "down"), _level(4, "down", 2),
              _level(4, "down", 4)]
    REFINES = [("refine1", 4), ("refine2", 2), ("refine31", 2), ("refine3", 2), ("refine4", 1), ("refine5", 1)]


# ---- the conditional NCSN ---------------------------------------------------


class CondResidualBlock(nn.Module):
    """The NCSN residual block under conditional InstanceNorm++."""

    def __init__(self, in_ch: int, out_ch: int, num_classes: int, act: Callable, resample: Optional[str] = None,
                 adjust_padding: bool = False, dilation: int = 1):
        super().__init__()
        self.act = act
        norm = lambda ch: ConditionalInstanceNorm2dPlus(ch, num_classes)  # noqa: E731
        self.norm0 = norm(in_ch)
        self.shortcut = None
        if resample == "down":
            self.conv0 = NCSNConv(in_ch, in_ch, dilation=dilation)
            self.norm1 = norm(in_ch)
            if dilation > 1:
                self.conv1 = NCSNConv(in_ch, out_ch, dilation=dilation)
                self.shortcut = NCSNConv(in_ch, out_ch, dilation=dilation)
            else:
                self.conv1 = ConvMeanPool(in_ch, out_ch, 3, adjust_padding=adjust_padding)
                self.shortcut = ConvMeanPool(in_ch, out_ch, 1, adjust_padding=adjust_padding)
        else:
            d = max(dilation, 1)
            self.conv0 = NCSNConv(in_ch, out_ch, dilation=d)
            self.norm1 = norm(out_ch)
            self.conv1 = NCSNConv(out_ch, out_ch, dilation=d)
            if not (in_ch == out_ch and resample is None):
                self.shortcut = NCSNConv(in_ch, out_ch, 1)

    def forward(self, x, y):
        h = self.conv0(self.act(self.norm0(x, y)))
        h = self.conv1(self.act(self.norm1(h, y)))
        return (x if self.shortcut is None else self.shortcut(x)) + h


class CondCRPBlock(nn.Module):
    def __init__(self, features: int, n_stages: int, num_classes: int, act: Callable):
        super().__init__()
        self.act, self.n_stages = act, n_stages
        for i in range(n_stages):
            self.add_module(f"norm{i}", ConditionalInstanceNorm2dPlus(features, num_classes))
            self.add_module(f"conv{i}", NCSNConv(features, features, bias=False))

    def forward(self, x, y):
        x = self.act(x)
        path = x
        for i in range(self.n_stages):
            path = getattr(self, f"norm{i}")(path, y)
            path = getattr(self, f"conv{i}")(pool5(path, "avg"))
            x = path + x
        return x


class CondRCUBlock(nn.Module):
    def __init__(self, features: int, n_blocks: int, n_stages: int, num_classes: int, act: Callable):
        super().__init__()
        self.act, self.n_blocks, self.n_stages = act, n_blocks, n_stages
        for i in range(n_blocks):
            for j in range(n_stages):
                self.add_module(f"norm_{i}_{j}", ConditionalInstanceNorm2dPlus(features, num_classes))
                self.add_module(f"conv_{i}_{j}", NCSNConv(features, features, bias=False))

    def forward(self, x, y):
        for i in range(self.n_blocks):
            residual = x
            for j in range(self.n_stages):
                x = self.act(getattr(self, f"norm_{i}_{j}")(x, y))
                x = getattr(self, f"conv_{i}_{j}")(x)
            x = x + residual
        return x


class CondMSFBlock(nn.Module):
    def __init__(self, in_chs: Sequence[int], features: int, num_classes: int):
        super().__init__()
        self.n_inputs = len(in_chs)
        for i, ch in enumerate(in_chs):
            self.add_module(f"norm{i}", ConditionalInstanceNorm2dPlus(ch, num_classes))
            self.add_module(f"conv{i}", NCSNConv(ch, features, bias=True))

    def forward(self, xs, y, shape):
        out = 0.0
        for i in range(self.n_inputs):
            h = getattr(self, f"conv{i}")(getattr(self, f"norm{i}")(xs[i], y))
            out = out + bilinear_resize_align_corners(h, shape)
        return out


class CondRefineBlock(nn.Module):
    def __init__(self, in_chs: Sequence[int], features: int, num_classes: int, act: Callable, end: bool = False):
        super().__init__()
        self.n_inputs = len(in_chs)
        for i, ch in enumerate(in_chs):
            self.add_module(f"adapt{i}", CondRCUBlock(ch, 2, 2, num_classes, act))
        if self.n_inputs > 1:
            self.msf = CondMSFBlock(in_chs, features, num_classes)
        self.crp = CondCRPBlock(features, 2, num_classes, act)
        self.out = CondRCUBlock(features, 3 if end else 1, 2, num_classes, act)

    def forward(self, xs, y, shape):
        hs = [getattr(self, f"adapt{i}")(x, y) for i, x in enumerate(xs)]
        h = self.msf(hs, y, shape) if self.n_inputs > 1 else hs[0]
        return self.out(self.crp(h, y), y)


@register_model(name="ncsn")
class NCSN(_NCSNv2Base):
    """The original NCSN: conditional InstanceNorm++ on ``cond`` cast to an
    integer class (JAX ``cond.astype(int32)``: a float sigma label is
    truncated, so the class is floor(sigma), not the level index)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        nf, act, K = self.nf, self.act, self.num_scales
        self.begin_conv = NCSNConv(self.num_channels, nf)
        blocks = [
            ("res0_0", nf, nf, {}), ("res0_1", nf, nf, {}),
            ("res1_0", nf, 2 * nf, dict(resample="down")), ("res1_1", 2 * nf, 2 * nf, {}),
            ("res2_0", 2 * nf, 2 * nf, dict(resample="down", dilation=2)),
            ("res2_1", 2 * nf, 2 * nf, dict(dilation=2)),
            ("res3_0", 2 * nf, 2 * nf, dict(resample="down", dilation=4, adjust_padding=self.image_size == 28)),
            ("res3_1", 2 * nf, 2 * nf, dict(dilation=4)),
        ]
        for name, cin, cout, kw in blocks:
            self.add_module(name, CondResidualBlock(cin, cout, K, act, **kw))
        self.refine1 = CondRefineBlock([2 * nf], 2 * nf, K, act)
        self.refine2 = CondRefineBlock([2 * nf, 2 * nf], 2 * nf, K, act)
        self.refine3 = CondRefineBlock([2 * nf, 2 * nf], nf, K, act)
        self.refine4 = CondRefineBlock([nf, nf], nf, K, act, end=True)
        self.normalizer = ConditionalInstanceNorm2dPlus(nf, K)
        self.end_conv = NCSNConv(nf, self.num_channels)

    def forward(self, x, cond):
        y = cond.to(torch.int32)
        h = self.begin_conv(self._input(x))
        levels = []
        for li in range(4):
            h = getattr(self, f"res{li}_1")(getattr(self, f"res{li}_0")(h, y), y)
            levels.append(h)
        l1, l2, l3, l4 = levels
        r1 = self.refine1([l4], y, l4.shape[1:3])
        r2 = self.refine2([l3, r1], y, l3.shape[1:3])
        r3 = self.refine3([l2, r2], y, l2.shape[1:3])
        out = self.refine4([l1, r3], y, l1.shape[1:3])
        return self.end_conv(self.act(self.normalizer(out, y)))
