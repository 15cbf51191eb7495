"""The FID InceptionV3 (JAX `eval/inception.py`, pytorch-fid's network with
the TF-FID patches) as a torch module tree, for FID and joint-FID
activations.

The submodules carry pytorch-fid's names (``Conv2d_1a_3x3``, ``Mixed_5b.
branch1x1``, ... each a ``conv`` without bias and a ``bn`` at eps 1e-3),
so the reference file `pt_inception-2015-12-05-6726825d.pth` loads with
``strict=True`` once the keys no tap reads (its 1008-way ``fc``) are
dropped, as JAX's loader drops them.  Inference only: BatchNorm runs on its
running statistics.  The FID patches: the average pools of the A, C and E
blocks count only the pixels inside the image, and Mixed_7c's pool branch
is a 3x3 max pool.  ``forward`` takes NHWC images in [0, 1], resizes them
to 299 as `jax.image.resize(..., "bilinear")` does (`ops.resize.
resize_bilinear`, antialiased where it shrinks), maps them to [-1, 1] and
returns the taps of ``output_blocks`` ({0: 64, 1: 192, 2: 768, 3: 2048}
channels, NHWC; block 3 spatially averaged to ``[B, 2048]``).

Weights: :func:`load_fid_inception` reads ``CSDT_INCEPTION_WEIGHTS`` (or a
path) and raises `FileNotFoundError` with the JAX package's message where
there is none; :func:`inception_state_from_flax` turns the JAX package's
folded parameter tree into this module's state dict.  The metrics run in
float32 with TF32 off (`ops.resize.full_float32`), or in float64.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import full_float32, resize_bilinear
from .metrics import FID_NOTE

BN_EPS = 1e-3


class BasicConv2d(nn.Module):
    """Conv (no bias) -> BatchNorm (eps 1e-3) -> ReLU."""

    def __init__(self, cin: int, cout: int, **kw):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, bias=False, **kw)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, kernel_size=1)
        self.branch5x5_1 = BasicConv2d(cin, 48, kernel_size=1)
        self.branch5x5_2 = BasicConv2d(48, 64, kernel_size=5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, kernel_size=1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, kernel_size=3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, kernel_size=1)
        self.branch7x7_1 = BasicConv2d(cin, c7, kernel_size=1)
        self.branch7x7_2 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, kernel_size=1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, kernel_size=1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = conv(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, kernel_size=1)
        self.branch3x3_2 = BasicConv2d(192, 320, kernel_size=3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, kernel_size=1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, kernel_size=3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(self.branch7x7x3_1(x))))
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    """Mixed_7b (``pool="avg"``) and Mixed_7c (``pool="max"``)."""

    def __init__(self, cin: int, pool: str):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(cin, 320, kernel_size=1)
        self.branch3x3_1 = BasicConv2d(cin, 384, kernel_size=1)
        self.branch3x3_2a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, kernel_size=3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, kernel_size=1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = _avg_pool(x) if self.pool == "avg" else F.max_pool2d(x, 3, stride=1, padding=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class InceptionV3FID(nn.Module):
    """The FID InceptionV3 with per-block taps (see the module docstring)."""

    def __init__(self, output_blocks: Sequence[int] = (3,), resize_input: bool = True, normalize_input: bool = True):
        super().__init__()
        self.output_blocks = tuple(sorted(output_blocks))
        self.resize_input, self.normalize_input = resize_input, normalize_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, kernel_size=3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, kernel_size=3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, kernel_size=3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, kernel_size=1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, kernel_size=3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")
        self.eval()

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        x = images
        if self.resize_input:
            x = resize_bilinear(x, (299, 299))
        if self.normalize_input:
            x = 2 * x - 1
        x = x.permute(0, 3, 1, 2)
        last, taps = max(self.output_blocks), {}
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        taps[0] = x = F.max_pool2d(x, 3, stride=2)
        if last >= 1:
            taps[1] = x = F.max_pool2d(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)), 3, stride=2)
        if last >= 2:
            for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a, self.Mixed_6b, self.Mixed_6c,
                          self.Mixed_6d, self.Mixed_6e):
                x = block(x)
            taps[2] = x
        if last >= 3:
            x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
            taps[3] = x.mean(dim=(2, 3), keepdim=True)
        return [taps[i].permute(0, 2, 3, 1).flatten(1) if i == 3 else taps[i].permute(0, 2, 3, 1)
                for i in self.output_blocks]


def inception_state_from_flax(params: Dict) -> Dict[str, torch.Tensor]:
    """The JAX package's folded parameter tree (each BasicConv2d a ``conv``
    with an HWIO ``kernel`` and the folded ``bias``), as numpy or JAX
    arrays, as a state dict of :class:`InceptionV3FID`: the kernel OIHW,
    the bias in ``bn.bias`` over a unit scale (``bn.weight`` 1, running
    mean 0, running variance 1 - eps)."""
    sd = {}
    for name, module in InceptionV3FID().named_modules():
        if not isinstance(module, BasicConv2d):
            continue
        node = params
        for part in name.split("."):
            node = node[part]
        kernel = np.asarray(node["conv"]["kernel"])
        cout = kernel.shape[-1]
        sd[f"{name}.conv.weight"] = torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
        sd[f"{name}.bn.weight"] = torch.ones(cout)
        sd[f"{name}.bn.bias"] = torch.from_numpy(np.asarray(node["conv"]["bias"]).copy())
        sd[f"{name}.bn.running_mean"] = torch.zeros(cout)
        sd[f"{name}.bn.running_var"] = torch.full((cout,), 1.0 - BN_EPS)
        sd[f"{name}.bn.num_batches_tracked"] = torch.tensor(0)
    return sd


def load_fid_inception(
    path: Optional[str] = None,
    output_blocks: Sequence[int] = (3,),
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> InceptionV3FID:
    """The FID Inception with the reference weights of ``path`` (default
    ``$CSDT_INCEPTION_WEIGHTS``), on ``device``; raises `FileNotFoundError`
    where there are none.  Keys outside the network (``fc.*``) are dropped,
    the rest loaded strictly."""
    path = path or os.environ.get("CSDT_INCEPTION_WEIGHTS", "")
    if not path or not os.path.isfile(path):
        raise FileNotFoundError(FID_NOTE)
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    model = InceptionV3FID(output_blocks)
    roots = {name for name, _ in model.named_children()}
    model.load_state_dict({k: v for k, v in sd.items() if k.split(".")[0] in roots}, strict=True)
    return model.to(device=device, dtype=dtype)


@torch.no_grad()
def activations(model: InceptionV3FID, images, batch: int = 32) -> np.ndarray:
    """The last (deepest) tap of ``model`` over NHWC [0, 1] ``images``
    (numpy or a tensor) in batches of ``batch``, as a float64 numpy array,
    in the model's floating type with TF32 off."""
    p = next(model.parameters())
    out = []
    with full_float32():
        for i in range(0, len(images), batch):
            out.append(model(_chunk(images, i, batch).to(p.device, p.dtype))[-1].double().cpu().numpy())
    return np.concatenate(out)


def _chunk(images, start: int, size: int) -> torch.Tensor:
    """``images[start:start + size]`` as a tensor (a numpy view copied)."""
    chunk = images[start : start + size]
    return chunk if torch.is_tensor(chunk) else torch.from_numpy(np.ascontiguousarray(chunk))
