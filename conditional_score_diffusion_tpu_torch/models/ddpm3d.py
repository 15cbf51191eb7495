"""3-D DDPM U-Net for volumes (MRI -> PET), NDHWC, in PyTorch (JAX
`models/ddpm3d.py`: `ddpm3D`, `ddpm3D_paired`, `ddpm3D_paired_SR3`).

3x3x3 convs, conv shortcuts, no attention; `Downsample3D` pads each spatial
axis by (0, 1) and convolves with stride 2 (or average-pools), `Upsample3D`
repeats each voxel twice along each axis (a nearest resize by 2, as JAX's
`jax.image.resize`; its reference's 2-D upsample fails on volumes).  The
paired variants concatenate x and y on channels.  Submodules carry the JAX
module names, so a ``state_dict`` key is the Flax parameter path
(`models/convert.py`).  No kernel of `ops` takes a volume: every resblock
runs its plain path (`layers.FusedResblock`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import register_model
from .ddpm import _ACTS, DDPMPaired
from .layers import Conv3x3, Dense, ResnetBlockDDPM, get_timestep_embedding, legacy_group_norm


class Downsample3D(nn.Module):
    """Stride-2 3x3x3 conv after a (0, 1) pad of each spatial axis, or a
    2x2x2 average pool."""

    def __init__(self, channels: int, with_conv: bool = False):
        super().__init__()
        self.conv = Conv3x3(channels, channels, stride=2, padding=0, dim=3) if with_conv else None

    def forward(self, x):
        if self.conv is not None:
            return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1, 0, 1)))
        return F.avg_pool3d(x.permute(0, 4, 1, 2, 3), 2, 2).permute(0, 2, 3, 4, 1)


class Upsample3D(nn.Module):
    """Nearest x2 along each spatial axis, and an optional 3x3x3 conv."""

    def __init__(self, channels: int, with_conv: bool = False):
        super().__init__()
        self.conv = Conv3x3(channels, channels, dim=3) if with_conv else None

    def forward(self, x):
        h = F.interpolate(x.permute(0, 4, 1, 2, 3), scale_factor=2, mode="nearest").permute(0, 2, 3, 4, 1)
        return self.conv(h) if self.conv is not None else h


@register_model(name="ddpm3D")
class DDPM3D(nn.Module):
    """The DDPM U-Net on NDHWC volumes; ``forward(x, cond)``."""

    def __init__(
        self,
        in_channels: int,
        nf: int,
        ch_mult: Sequence[int],
        num_res_blocks: int,
        dropout: float,
        resamp_with_conv: bool,
        conditional: bool,
        centered: bool,
        output_channels: int,
        nonlinearity: str = "swish",
        split_skip_convs: bool = False,
    ):
        super().__init__()
        self.act = act = _ACTS[nonlinearity]
        self.nf, self.conditional, self.centered = nf, conditional, centered
        num_resolutions = len(ch_mult)
        temb_dim = nf * 4 if conditional else None
        if conditional:
            self.temb0 = Dense(nf, nf * 4)
            self.temb1 = Dense(nf * 4, nf * 4)

        def resblock(in_ch, out_ch, split=False):
            return ResnetBlockDDPM(
                act, in_ch, out_ch, temb_dim=temb_dim, conv_shortcut=True, dropout=dropout, split_skip=split, dim=3,
            )

        self.conv_in = Conv3x3(in_channels, nf, dim=3)
        self._down_plan, self._up_plan = [], []
        hs_ch = [nf]
        for i_level in range(num_resolutions):
            for i_block in range(num_res_blocks):
                name = f"down_{i_level}_{i_block}"
                self.add_module(name, resblock(hs_ch[-1], nf * ch_mult[i_level]))
                self._down_plan.append(name)
                hs_ch.append(nf * ch_mult[i_level])
            if i_level != num_resolutions - 1:
                self.add_module(f"down_{i_level}", Downsample3D(hs_ch[-1], with_conv=resamp_with_conv))
                self._down_plan.append(f"down_{i_level}")
                hs_ch.append(hs_ch[-1])

        ch = hs_ch[-1]
        self.mid_block0 = resblock(ch, None)
        self.mid_block1 = resblock(ch, None)

        for i_level in reversed(range(num_resolutions)):
            for i_block in range(num_res_blocks + 1):
                name = f"up_{i_level}_{i_block}"
                out_ch = nf * ch_mult[i_level]
                self.add_module(name, resblock(ch + hs_ch.pop(), out_ch, split=split_skip_convs))
                self._up_plan.append(("block", name))
                ch = out_ch
            if i_level != 0:
                self.add_module(f"up_{i_level}", Upsample3D(ch, with_conv=resamp_with_conv))
                self._up_plan.append(("layer", f"up_{i_level}"))
        if hs_ch:
            raise AssertionError("unconsumed skip connections")

        self.norm_out = legacy_group_norm(ch)
        self.conv_out = Conv3x3(ch, output_channels, init_scale=0.0, dim=3)

    @classmethod
    def from_config(cls, config, in_channels=None):
        m = config.model
        return cls(
            in_channels=in_channels if in_channels is not None else m.get("input_channels", config.data.num_channels),
            nf=m.nf,
            ch_mult=tuple(m.ch_mult),
            num_res_blocks=m.num_res_blocks,
            dropout=m.dropout,
            resamp_with_conv=m.resamp_with_conv,
            conditional=m.conditional,
            centered=config.data.centered,
            output_channels=m.output_channels,
            nonlinearity=m.nonlinearity.lower(),
            split_skip_convs=m.get("split_skip_convs", True),
        )

    def forward(self, x, cond):
        act = self.act
        if self.conditional:
            # sin/cos in float32, then the activation dtype
            temb = get_timestep_embedding(cond, self.nf).to(x.dtype)
            temb = self.temb1(act(self.temb0(temb)))
        else:
            temb = None

        h = x if self.centered else 2 * x - 1.0
        hs = [self.conv_in(h)]
        for name in self._down_plan:
            layer = getattr(self, name)
            hs.append(layer(hs[-1], temb) if isinstance(layer, ResnetBlockDDPM) else layer(hs[-1]))

        h = hs[-1]
        h = self.mid_block0(h, temb)
        h = self.mid_block1(h, temb)
        for kind, name in self._up_plan:
            h = getattr(self, name)(h, temb, skip=hs.pop()) if kind == "block" else getattr(self, name)(h)
        h = act(self.norm_out(h))
        return self.conv_out(h)


@register_model(name="ddpm3D_paired")
class DDPM3DPaired(DDPMPaired):
    """Joint score of (x, y) volumes: concat on channels, split the output."""

    @classmethod
    def from_config(cls, config):
        d = config.data
        return cls(DDPM3D.from_config(config, in_channels=d.shape_x[0] + d.shape_y[0]))


@register_model(name="ddpm3D_paired_SR3")
class DDPM3DPairedSR3(DDPM3DPaired):
    """SR3/CDE on volumes: y enters the network clean, the output is the
    score of x alone."""

    def forward(self, inputs, cond):
        return self.unet(torch.cat([inputs["x"], inputs["y"]], dim=-1), cond)
