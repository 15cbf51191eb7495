"""LPIPS (AlexNet) perceptual distance, copied from the JAX package's
`eval/lpips.py` as a torch module.

The AlexNet features keep torchvision's layout (``features.{0,3,6,8,10}``
the five convs, a 3x3 / 2 max pool after the first two ReLUs), so the
``features.*`` keys of a torchvision alexnet state dict load strictly; the
five 1x1 heads carry lpips' names (``lin{i}.model.1.weight``, no bias), so
lpips' `alex.pth` loads strictly too.  A distance: both images, NHWC in
[0, 1], mapped to [-1, 1] and through lpips' scaling layer (``(x -
SHIFT) / SCALE``), the ReLU taps relu1..relu5, each unit-normalised over
its channels (eps 1e-10), the squared difference weighted by the head and
summed over channels, averaged over the pixels, summed over the five
layers: one value an image.

Weights: :func:`load_lpips` reads ``CSDT_LPIPS_ALEXNET`` and
``CSDT_LPIPS_LIN`` (or paths) and raises `FileNotFoundError` with the JAX
package's messages where they are absent; :func:`lpips_state_from_flax`
turns the JAX package's parameter tree into this module's state dict.  It
runs in float32 with TF32 off (`ops.resize.full_float32`), or in float64.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from ..ops.resize import full_float32
from .metrics import LPIPS_LIN_NOTE, LPIPS_NOTE

# (out_channels, kernel, stride, padding) of AlexNet's convs, at features.{0,3,6,8,10}
ALEX_CONVS = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1)]
ALEX_INDICES = (0, 3, 6, 8, 10)
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


class _Lin(nn.Module):
    """One lpips head: dropout (off in eval) and a 1x1 conv to one channel."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(), nn.Conv2d(channels, 1, 1, bias=False))


class LPIPS(nn.Module):
    """``lpips(img1, img2)``: the [B] distances of two NHWC [0, 1] batches."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for i, (cout, k, s, p) in enumerate(ALEX_CONVS):
            layers += [nn.Conv2d(cin, cout, k, stride=s, padding=p), nn.ReLU()]
            if i < 2 or i == len(ALEX_CONVS) - 1:
                layers.append(nn.MaxPool2d(3, stride=2))
            cin = cout
        self.features = nn.Sequential(*layers)
        for i, (cout, *_) in enumerate(ALEX_CONVS):
            setattr(self, f"lin{i}", _Lin(cout))
        self.register_buffer("shift", torch.tensor(SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(SCALE).view(1, 3, 1, 1), persistent=False)
        self.eval()

    def taps(self, x: torch.Tensor):
        """relu1..relu5 of NCHW ``x`` in [-1, 1]."""
        h, out = (x - self.shift) / self.scale, []
        for layer in self.features[:-1]:  # the last pool feeds no tap
            h = layer(h)
            if isinstance(layer, nn.ReLU):
                out.append(h)
        return out

    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        f1 = self.taps((2 * img1 - 1).permute(0, 3, 1, 2))
        f2 = self.taps((2 * img2 - 1).permute(0, 3, 1, 2))
        total = 0.0
        for i, (a, b) in enumerate(zip(f1, f2)):
            d = (_unit(a) - _unit(b)) ** 2
            w = getattr(self, f"lin{i}").model[1].weight.view(1, -1, 1, 1)
            total = total + (d * w).sum(dim=1).mean(dim=(1, 2))
        return total


def _unit(feat: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return feat / (torch.sqrt(torch.sum(feat**2, dim=1, keepdim=True)) + eps)


def lpips_state_from_flax(params: Dict) -> Dict[str, torch.Tensor]:
    """The JAX package's LPIPS tree (``{"alex": {"conv{i}": {"kernel" HWIO,
    "bias"}}, "lin": {"lin{i}": [C]}}``, numpy or JAX arrays) as a state
    dict of :class:`LPIPS`."""
    sd = {}
    for i, idx in enumerate(ALEX_INDICES):
        conv = params["alex"][f"conv{i}"]
        kernel = np.asarray(conv["kernel"]).transpose(3, 2, 0, 1)
        sd[f"features.{idx}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel))
        sd[f"features.{idx}.bias"] = torch.from_numpy(np.asarray(conv["bias"]).copy())
        head = np.asarray(params["lin"][f"lin{i}"]).reshape(1, -1, 1, 1)
        sd[f"lin{i}.model.1.weight"] = torch.from_numpy(head.copy())
    return sd


def load_lpips(
    alexnet_path: Optional[str] = None, lin_path: Optional[str] = None, device="cuda", dtype=torch.float32
) -> LPIPS:
    """LPIPS with the weights of a torchvision alexnet state dict (default
    ``$CSDT_LPIPS_ALEXNET``; its ``features.*`` keys) and of lpips'
    `alex.pth` (default ``$CSDT_LPIPS_LIN``), on ``device``; raises
    `FileNotFoundError` where either is absent."""
    alexnet_path = alexnet_path or os.environ.get("CSDT_LPIPS_ALEXNET", "")
    lin_path = lin_path or os.environ.get("CSDT_LPIPS_LIN", "")
    if not (alexnet_path and os.path.isfile(alexnet_path)):
        raise FileNotFoundError(LPIPS_NOTE)
    if not (lin_path and os.path.isfile(lin_path)):
        raise FileNotFoundError(LPIPS_LIN_NOTE)
    alex = torch.load(alexnet_path, map_location="cpu", weights_only=False)
    lin = torch.load(lin_path, map_location="cpu", weights_only=False)
    model = LPIPS()
    model.load_state_dict({**{k: v for k, v in alex.items() if k.startswith("features.")}, **lin}, strict=True)
    return model.to(device=device, dtype=dtype)


@torch.no_grad()
def distances(model: LPIPS, img1, img2, batch: int = 64) -> np.ndarray:
    """The per-image distances of two NHWC [0, 1] sets (numpy or tensors),
    in batches of ``batch``, as float64 numpy, in the model's floating type
    with TF32 off."""
    p = next(model.parameters())
    out = []
    with full_float32():
        for i in range(0, len(img1), batch):
            a, b = (_chunk(img, i, batch).to(p.device, p.dtype) for img in (img1, img2))
            out.append(model(a, b).double().cpu().numpy())
    return np.concatenate(out)


def _chunk(images, start: int, size: int) -> torch.Tensor:
    """``images[start:start + size]`` as a tensor (a numpy view copied)."""
    chunk = images[start : start + size]
    return chunk if torch.is_tensor(chunk) else torch.from_numpy(np.ascontiguousarray(chunk))
