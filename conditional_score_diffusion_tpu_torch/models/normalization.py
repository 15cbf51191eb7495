"""The NCSN lineage's normalizations, NHWC (JAX `models/normalization.py`).

Each module keeps the JAX parameter names (``alpha``, ``gamma``, ``beta``,
and ``embed.embedding``: the class-conditional table of ``nn.Embed``), so
`models/convert.py` carries them over as they are.  Scales and the
embedding tables start at 1 + N(0, 0.02), biases at 0, drawn from torch's
default generator.  The conditional norms split one embedding row per
class into their gamma/alpha/beta chunks and subtract 1 from the beta
chunk at apply time, as JAX does (its table is initialised around 1 for
every chunk).

Statistics: the instance norms use the biased spatial variance with eps
1e-5; InstanceNorm++ normalizes the per-channel means with their unbiased
variance across channels (``ddof=1``, torch.var's default in the
reference).
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.nn as nn

EPS = 1e-5


def _ones_plus_noise(*shape) -> nn.Parameter:
    return nn.Parameter(1.0 + 0.02 * torch.randn(*shape))


def _spatial_var(x):
    return x.var(dim=(1, 2), unbiased=False, keepdim=True)


def _instance_norm(x):
    """Per-sample, per-channel spatial normalization, no affine."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    return (x - mean) / torch.sqrt(_spatial_var(x) + EPS)


def _normalized_means(x):
    """The per-channel spatial means ``(B, C)``, standardized across the
    channels with the unbiased variance."""
    means = x.mean(dim=(1, 2))
    m = means.mean(dim=-1, keepdim=True)
    v = means.var(dim=-1, keepdim=True, unbiased=True)
    return (means - m) / torch.sqrt(v + EPS)


def _pixel(v):
    """``(B, C)`` -> ``(B, 1, 1, C)``."""
    return v[:, None, None, :]


class Embed(nn.Module):
    """`flax.linen.Embed`: a ``(num_classes, width)`` table indexed by the
    integer labels."""

    def __init__(self, num_classes: int, width: int):
        super().__init__()
        self.embedding = _ones_plus_noise(num_classes, width)

    def forward(self, y):
        return self.embedding[y.long()]


class InstanceNorm2d(nn.Module):
    def __init__(self, features: int):
        super().__init__()

    def forward(self, x):
        return _instance_norm(x)


class InstanceNorm2dPlus(nn.Module):
    """Instance norm, the standardized channel means re-injected by
    ``alpha``, then ``gamma * h (+ beta)``."""

    def __init__(self, features: int, bias: bool = True):
        super().__init__()
        self.alpha = _ones_plus_noise(features)
        self.gamma = _ones_plus_noise(features)
        self.beta = nn.Parameter(torch.zeros(features)) if bias else None

    def forward(self, x):
        h = _instance_norm(x) + _pixel(_normalized_means(x)) * self.alpha
        out = self.gamma * h
        return out if self.beta is None else out + self.beta


class VarianceNorm2d(nn.Module):
    """Division by the spatial standard deviation (no centring), times
    ``alpha``."""

    def __init__(self, features: int, bias: bool = False):
        super().__init__()
        self.alpha = _ones_plus_noise(features)

    def forward(self, x):
        return self.alpha * (x / torch.sqrt(_spatial_var(x) + EPS))


class NoneNorm2d(nn.Module):
    def __init__(self, features: int):
        super().__init__()

    def forward(self, x):
        return x


class _Conditional(nn.Module):
    """A norm with a class-conditional affine: ``chunks`` chunks of
    ``features`` per table row, the last of them a bias when ``bias``."""

    def __init__(self, features: int, num_classes: int, bias: bool, chunks: int):
        super().__init__()
        self.features, self.bias = features, bias
        self.embed = Embed(num_classes, chunks * features)

    def affine(self, y, n: int):
        """The ``n`` chunks of the labels' rows, ``(B, 1, 1, C)`` each, the
        bias chunk less 1."""
        parts = list(self.embed(y).chunk(n, dim=-1))
        if self.bias:
            parts[-1] = parts[-1] - 1.0
        return [_pixel(p) for p in parts]


class ConditionalInstanceNorm2dPlus(_Conditional):
    """InstanceNorm++ with per-class (gamma, alpha[, beta])."""

    def __init__(self, features: int, num_classes: int, bias: bool = True):
        super().__init__(features, num_classes, bias, 3 if bias else 2)

    def forward(self, x, y):
        means = _pixel(_normalized_means(x))
        h = _instance_norm(x)
        if self.bias:
            gamma, alpha, beta = self.affine(y, 3)
            return gamma * (h + means * alpha) + beta
        gamma, alpha = self.affine(y, 2)
        return gamma * (h + means * alpha)


class ConditionalInstanceNorm2d(_Conditional):
    def __init__(self, features: int, num_classes: int, bias: bool = True):
        super().__init__(features, num_classes, bias, 2 if bias else 1)

    def forward(self, x, y):
        h = _instance_norm(x)
        if self.bias:
            gamma, beta = self.affine(y, 2)
            return gamma * h + beta
        (gamma,) = self.affine(y, 1)
        return gamma * h


class ConditionalVarianceNorm2d(_Conditional):
    def __init__(self, features: int, num_classes: int, bias: bool = False):
        super().__init__(features, num_classes, False, 1)

    def forward(self, x, y):
        (gamma,) = self.affine(y, 1)
        return gamma * (x / torch.sqrt(_spatial_var(x) + EPS))


class ConditionalNoneNorm2d(_Conditional):
    def __init__(self, features: int, num_classes: int, bias: bool = True):
        super().__init__(features, num_classes, bias, 2 if bias else 1)

    def forward(self, x, y):
        if self.bias:
            gamma, beta = self.affine(y, 2)
            return gamma * x + beta
        (gamma,) = self.affine(y, 1)
        return gamma * x


class ConditionalBatchNorm2d(_Conditional):
    """Batch statistics of the call itself (JAX: the reference's
    train-mode BatchNorm; no running statistics)."""

    def __init__(self, features: int, num_classes: int, bias: bool = True):
        super().__init__(features, num_classes, bias, 2 if bias else 1)

    def forward(self, x, y):
        mean = x.mean(dim=(0, 1, 2), keepdim=True)
        var = x.var(dim=(0, 1, 2), unbiased=False, keepdim=True)
        h = (x - mean) / torch.sqrt(var + EPS)
        if self.bias:
            gamma, beta = self.affine(y, 2)
            return gamma * h + beta
        (gamma,) = self.affine(y, 1)
        return gamma * h


def get_normalization(config, conditional: bool = False) -> Callable:
    """``norm(features) -> module`` of ``config.model.normalization`` (JAX
    `get_normalization`; conditional: ``norm(features)`` takes ``(x, y)``)."""
    norm = config.model.normalization
    if conditional:
        if norm == "InstanceNorm++":
            return functools.partial(ConditionalInstanceNorm2dPlus, num_classes=config.model.num_classes)
        raise NotImplementedError(f"{norm} not implemented yet.")
    if norm == "InstanceNorm":
        return InstanceNorm2d
    if norm == "InstanceNorm++":
        return InstanceNorm2dPlus
    if norm == "VarianceNorm":
        return VarianceNorm2d
    if norm == "GroupNorm":
        from .layers import legacy_group_norm

        return legacy_group_norm
    raise ValueError(f"Unknown normalization: {norm}")
