"""Plain-torch replicas of pytorch-fid's FID InceptionV3 and of lpips-alex
with the reference state-dict names, and seeded synthetic weights for
them, copied from `tests/test_inception_lpips_oracle.py` for the port's
perceptual-metric tests (`tests/test_torch_perceptual.py`)."""

import numpy as np
import torch
import torch.nn as tnn
import torch.nn.functional as F


class TBasic(tnn.Module):
    def __init__(self, cin, cout, **kw):
        super().__init__()
        self.conv = tnn.Conv2d(cin, cout, bias=False, **kw)
        self.bn = tnn.BatchNorm2d(cout, eps=0.001)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class TInceptionA(tnn.Module):
    """FIDInceptionA: avg-pool branch with count_include_pad=False
    (reference `models/inception.py:210-234`)."""

    def __init__(self, cin, pool_features):
        super().__init__()
        self.branch1x1 = TBasic(cin, 64, kernel_size=1)
        self.branch5x5_1 = TBasic(cin, 48, kernel_size=1)
        self.branch5x5_2 = TBasic(48, 64, kernel_size=5, padding=2)
        self.branch3x3dbl_1 = TBasic(cin, 64, kernel_size=1)
        self.branch3x3dbl_2 = TBasic(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = TBasic(96, 96, kernel_size=3, padding=1)
        self.branch_pool = TBasic(cin, pool_features, kernel_size=1)

    def forward(self, x):
        bp = F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)
        return torch.cat(
            [
                self.branch1x1(x),
                self.branch5x5_2(self.branch5x5_1(x)),
                self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
                self.branch_pool(bp),
            ],
            1,
        )


class TInceptionB(tnn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3 = TBasic(cin, 384, kernel_size=3, stride=2)
        self.branch3x3dbl_1 = TBasic(cin, 64, kernel_size=1)
        self.branch3x3dbl_2 = TBasic(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = TBasic(96, 96, kernel_size=3, stride=2)

    def forward(self, x):
        return torch.cat(
            [
                self.branch3x3(x),
                self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
                F.max_pool2d(x, 3, stride=2),
            ],
            1,
        )


class TInceptionC(tnn.Module):
    """FIDInceptionC (reference `models/inception.py:236-265`)."""

    def __init__(self, cin, c7):
        super().__init__()
        self.branch1x1 = TBasic(cin, 192, kernel_size=1)
        self.branch7x7_1 = TBasic(cin, c7, kernel_size=1)
        self.branch7x7_2 = TBasic(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7_3 = TBasic(c7, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = TBasic(cin, c7, kernel_size=1)
        self.branch7x7dbl_2 = TBasic(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = TBasic(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = TBasic(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = TBasic(c7, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch_pool = TBasic(cin, 192, kernel_size=1)

    def forward(self, x):
        bp = F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_5(
            self.branch7x7dbl_4(
                self.branch7x7dbl_3(self.branch7x7dbl_2(self.branch7x7dbl_1(x)))
            )
        )
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(bp)], 1)


class TInceptionD(tnn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3_1 = TBasic(cin, 192, kernel_size=1)
        self.branch3x3_2 = TBasic(192, 320, kernel_size=3, stride=2)
        self.branch7x7x3_1 = TBasic(cin, 192, kernel_size=1)
        self.branch7x7x3_2 = TBasic(192, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7x3_3 = TBasic(192, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7x3_4 = TBasic(192, 192, kernel_size=3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(
            self.branch7x7x3_3(self.branch7x7x3_2(self.branch7x7x3_1(x)))
        )
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class TInceptionE(tnn.Module):
    """FIDInceptionE_1 (avg pool, count_include_pad=False) / _2 (max pool)
    (reference `models/inception.py:268-322`)."""

    def __init__(self, cin, pool_type):
        super().__init__()
        self.pool_type = pool_type
        self.branch1x1 = TBasic(cin, 320, kernel_size=1)
        self.branch3x3_1 = TBasic(cin, 384, kernel_size=1)
        self.branch3x3_2a = TBasic(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3_2b = TBasic(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = TBasic(cin, 448, kernel_size=1)
        self.branch3x3dbl_2 = TBasic(448, 384, kernel_size=3, padding=1)
        self.branch3x3dbl_3a = TBasic(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = TBasic(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch_pool = TBasic(cin, 192, kernel_size=1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.pool_type == "avg":
            bp = F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)
        else:
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class TFIDInception(tnn.Module):
    """pt_inception-keyed FID InceptionV3 with per-block taps."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = TBasic(3, 32, kernel_size=3, stride=2)
        self.Conv2d_2a_3x3 = TBasic(32, 32, kernel_size=3)
        self.Conv2d_2b_3x3 = TBasic(32, 64, kernel_size=3, padding=1)
        self.Conv2d_3b_1x1 = TBasic(64, 80, kernel_size=1)
        self.Conv2d_4a_3x3 = TBasic(80, 192, kernel_size=3)
        self.Mixed_5b = TInceptionA(192, 32)
        self.Mixed_5c = TInceptionA(256, 64)
        self.Mixed_5d = TInceptionA(288, 64)
        self.Mixed_6a = TInceptionB(288)
        self.Mixed_6b = TInceptionC(768, 128)
        self.Mixed_6c = TInceptionC(768, 160)
        self.Mixed_6d = TInceptionC(768, 160)
        self.Mixed_6e = TInceptionC(768, 192)
        self.Mixed_7a = TInceptionD(768)
        self.Mixed_7b = TInceptionE(1280, "avg")
        self.Mixed_7c = TInceptionE(2048, "max")

    def forward(self, x):
        taps = []
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        taps.append(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        taps.append(x)
        x = self.Mixed_5d(self.Mixed_5c(self.Mixed_5b(x)))
        x = self.Mixed_6e(self.Mixed_6d(self.Mixed_6c(self.Mixed_6b(self.Mixed_6a(x)))))
        taps.append(x)
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        x = x.mean(dim=(2, 3))
        taps.append(x)
        return taps


def _randomize(model, seed=0):
    """Random-but-sane weights incl. nontrivial BN running stats, so BN
    folding is actually exercised (not identity)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, tnn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=g)
            elif isinstance(m, tnn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.uniform_(-0.1, 0.1, generator=g)
                m.running_mean.uniform_(-0.2, 0.2, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    model.eval()
    return model


def _alexnet_state_dict(seed=0):
    """Synthetic torchvision-style alexnet features state dict (conv layers
    at features.{0,3,6,8,10})."""
    g = np.random.RandomState(seed)
    cfg = [(64, 3, 11), (192, 64, 5), (384, 192, 3), (256, 384, 3), (256, 256, 3)]
    sd = {}
    for idx, (cout, cin, k) in zip([0, 3, 6, 8, 10], cfg):
        w = g.normal(0, (2.0 / (cin * k * k)) ** 0.5, (cout, cin, k, k))
        sd[f"features.{idx}.weight"] = torch.from_numpy(w.astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.from_numpy(
            g.uniform(-0.05, 0.05, cout).astype(np.float32)
        )
    return sd


def _lin_state_dict(seed=1):
    g = np.random.RandomState(seed)
    chans = [64, 192, 384, 256, 256]
    return {
        f"lin{i}.model.1.weight": torch.from_numpy(
            g.uniform(0, 0.1, (1, c, 1, 1)).astype(np.float32)
        )
        for i, c in enumerate(chans)
    }


def _torch_lpips(alex_sd, lin_sd, x1, x2):
    """Plain-torch lpips-alex oracle: scaling layer, relu taps, channel-unit
    normalization, non-negative 1x1 heads, spatial mean, layer sum."""
    shift = torch.tensor([-0.030, -0.088, -0.188]).view(1, 3, 1, 1)
    scale = torch.tensor([0.458, 0.448, 0.450]).view(1, 3, 1, 1)

    def feats(x):
        h = (x - shift) / scale
        taps = []
        layer_params = [(0, 4, 2), (3, 1, 2), (6, 1, 1), (8, 1, 1), (10, 1, 1)]
        for i, (idx, stride, pad) in enumerate(layer_params):
            h = F.conv2d(
                h, alex_sd[f"features.{idx}.weight"], alex_sd[f"features.{idx}.bias"],
                stride=stride, padding=pad,
            )
            h = F.relu(h)
            taps.append(h)
            if i in (0, 1):
                h = F.max_pool2d(h, 3, stride=2)
        return taps

    def unit(f):
        return f / (f.pow(2).sum(dim=1, keepdim=True).sqrt() + 1e-10)

    f1, f2 = feats(x1), feats(x2)
    total = 0.0
    for i, (a, b) in enumerate(zip(f1, f2)):
        d = (unit(a) - unit(b)) ** 2
        w = lin_sd[f"lin{i}.model.1.weight"]
        total = total + F.conv2d(d, w).mean(dim=(1, 2, 3))
    return total
