"""DDPM U-Net and its paired (x, y) variants in PyTorch, NHWC (JAX
`models/ddpm.py`: `DDPM`, `DDPMPaired`, `DDPMPairedSR3`, `DDPM2xSR` and its
alias `DDPMSR`, `DDPMKxSR`, `DDPMMultiSpeedHaar`).

Submodules carry the JAX module names (``conv_in``, ``down_0_0``,
``down_attn_3_0``, ``mid_block0``, ``up_5_2``, ``norm_out``, ...), so a
``state_dict`` key is the Flax parameter path with the leaf renamed.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.haar import haar_backward, haar_forward
from . import register_model
from .layers import (
    AttnBlock,
    Conv3x3,
    Dense,
    Downsample,
    ResnetBlockDDPM,
    Upsample,
    get_timestep_embedding,
    legacy_group_norm,
)

def squeeze2x(z: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Space-to-depth by 2 of NHWC ``z`` (its inverse with ``reverse``);
    output channel ``4*c + (2*dy + dx)``, as in the JAX package."""
    B, H, W, C = z.shape
    if not reverse:
        z = z.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 5, 2, 4)
        return z.reshape(B, H // 2, W // 2, 4 * C)
    z = z.reshape(B, H, W, C // 4, 2, 2).permute(0, 1, 4, 2, 5, 3)
    return z.reshape(B, H * 2, W * 2, C // 4)


_ACTS = {
    "elu": F.elu,
    "relu": F.relu,
    "lrelu": lambda x: F.leaky_relu(x, 0.2),
    "swish": F.silu,
}


@register_model(name="ddpm")
class DDPM(nn.Module):
    """Classic DDPM U-Net on NHWC input; ``forward(x, cond)``."""

    def __init__(
        self,
        in_channels: int,
        nf: int,
        ch_mult: Sequence[int],
        num_res_blocks: int,
        attn_resolutions: Sequence[int],
        dropout: float,
        resamp_with_conv: bool,
        image_size: int,
        conditional: bool,
        centered: bool,
        output_channels: int,
        nonlinearity: str = "swish",
        split_skip_convs: bool = False,
        fused_tail: bool = False,
        fused_block: bool = False,
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
                act, in_ch, out_ch, temb_dim=temb_dim, dropout=dropout,
                split_skip=split, fused_tail=fused_tail, fused_block=fused_block,
            )

        # The encoder and decoder are fixed sequences of (kind, name) steps,
        # built here with the channel bookkeeping and replayed by forward.
        self.conv_in = Conv3x3(in_channels, nf)
        self._down_plan, self._up_plan = [], []
        hs_ch, res = [nf], image_size
        for i_level in range(num_resolutions):
            for i_block in range(num_res_blocks):
                name = f"down_{i_level}_{i_block}"
                out_ch = nf * ch_mult[i_level]
                self.add_module(name, resblock(hs_ch[-1], out_ch))
                attn = f"down_attn_{i_level}_{i_block}" if res in attn_resolutions else None
                if attn is not None:
                    self.add_module(attn, AttnBlock(out_ch))
                self._down_plan.append(("block", name, attn))
                hs_ch.append(out_ch)
            if i_level != num_resolutions - 1:
                self.add_module(f"down_{i_level}", Downsample(hs_ch[-1], with_conv=resamp_with_conv))
                self._down_plan.append(("downsample", f"down_{i_level}", None))
                hs_ch.append(hs_ch[-1])
                res //= 2

        ch = hs_ch[-1]
        self.mid_block0 = resblock(ch, None)
        self.mid_attn = AttnBlock(ch)
        self.mid_block1 = resblock(ch, None)

        for i_level in reversed(range(num_resolutions)):
            for i_block in range(num_res_blocks + 1):
                name = f"up_{i_level}_{i_block}"
                out_ch = nf * ch_mult[i_level]
                self.add_module(name, resblock(ch + hs_ch.pop(), out_ch, split=split_skip_convs))
                self._up_plan.append(("block", name))
                ch = out_ch
            if res in attn_resolutions:
                self.add_module(f"up_attn_{i_level}", AttnBlock(ch))
                self._up_plan.append(("layer", f"up_attn_{i_level}"))
            if i_level != 0:
                self.add_module(f"up_{i_level}", Upsample(ch, with_conv=resamp_with_conv))
                self._up_plan.append(("layer", f"up_{i_level}"))
                res *= 2
        if hs_ch:
            raise AssertionError("unconsumed skip connections")

        self.norm_out = legacy_group_norm(ch)
        self.conv_out = Conv3x3(ch, output_channels, init_scale=0.0)

    @classmethod
    def from_config(cls, config, in_channels=None):
        m = config.model
        return cls(
            in_channels=in_channels if in_channels is not None else m.get("input_channels", config.data.num_channels),
            nf=m.nf,
            ch_mult=tuple(m.ch_mult),
            num_res_blocks=m.num_res_blocks,
            attn_resolutions=tuple(m.attn_resolutions),
            dropout=m.dropout,
            resamp_with_conv=m.resamp_with_conv,
            image_size=config.data.effective_image_size,
            conditional=m.conditional,
            centered=config.data.centered,
            output_channels=m.output_channels,
            nonlinearity=m.nonlinearity.lower(),
            split_skip_convs=m.get("split_skip_convs", True),
            fused_tail=m.get("fused_tail", False),
            fused_block=m.get("fused_block", False),
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
        for kind, name, attn in self._down_plan:
            if kind == "block":
                h = getattr(self, name)(hs[-1], temb)
                if attn is not None:
                    h = getattr(self, attn)(h)
                hs.append(h)
            else:  # downsample
                hs.append(getattr(self, name)(hs[-1]))

        h = hs[-1]
        h = self.mid_block0(h, temb)
        h = self.mid_attn(h)
        h = self.mid_block1(h, temb)

        for kind, name in self._up_plan:
            if kind == "block":
                h = getattr(self, name)(h, temb, skip=hs.pop())
            else:  # attention or upsample
                h = getattr(self, name)(h)
        h = act(self.norm_out(h))
        return self.conv_out(h)


@register_model(name="ddpm_paired")
class DDPMPaired(nn.Module):
    """Joint score of (x, y): concat on channels, split the output."""

    def __init__(self, unet: DDPM):
        super().__init__()
        self.unet = unet

    @classmethod
    def from_config(cls, config):
        d = config.data
        return cls(DDPM.from_config(config, in_channels=d.shape_x[0] + d.shape_y[0]))

    def forward(self, inputs, cond):
        x, y = inputs["x"], inputs["y"]
        xc = x.shape[-1]
        out = self.unet(torch.cat([x, y], dim=-1), cond)
        return {"x": out[..., :xc], "y": out[..., xc:]}


@register_model(name="ddpm_paired_SR3")
class DDPMPairedSR3(DDPMPaired):
    """SR3/CDE estimator: y enters the network clean, the output is the
    score of x alone (JAX `DDPMPairedSR3`)."""

    def forward(self, inputs, cond):
        return self.unet(torch.cat([inputs["x"], inputs["y"]], dim=-1), cond)


@register_model(name="ddpm_2xSR")
class DDPM2xSR(DDPMPaired):
    """2x super-resolution: x space-to-depth by 2 beside the half-size y;
    the x score back to x's size."""

    @classmethod
    def from_config(cls, config):
        d = config.data
        y_channels = d.shape_y[0] if "shape_y" in d else d.shape_x[0]
        return cls(DDPM.from_config(config, in_channels=4 * d.shape_x[0] + y_channels))

    def forward(self, inputs, cond):
        xs = squeeze2x(inputs["x"])
        xc = xs.shape[-1]
        out = self.unet(torch.cat([xs, inputs["y"]], dim=-1), cond)
        return {"x": squeeze2x(out[..., :xc], reverse=True), "y": out[..., xc:]}


@register_model(name="ddpm_SR")
class DDPMSR(DDPM2xSR):
    """The name the legacy celebA bicubic multi-scale recipes give
    `ddpm_2xSR`."""


@register_model(name="ddpm_KxSR")
class DDPMKxSR(DDPMPaired):
    """K x super-resolution: y (``target_resolution / scale``) resized
    bilinearly up to x's size as input, the y score resized back down, both
    antialiased as `jax.image.resize` is (`models.ncsnpp.resize_bilinear`)."""

    def __init__(self, unet: DDPM, target_resolution: int, scale: int):
        super().__init__(unet)
        self.target_resolution, self.scale = target_resolution, scale

    @classmethod
    def from_config(cls, config):
        d = config.data
        unet = DDPM.from_config(config, in_channels=d.shape_x[0] + d.shape_y[0])
        return cls(unet, d.target_resolution, d.scale)

    def forward(self, inputs, cond):
        from .ncsnpp import resize_bilinear

        x, y = inputs["x"], inputs["y"]
        gt = self.target_resolution
        xc = x.shape[-1]
        out = self.unet(torch.cat([x, resize_bilinear(y, gt)], dim=-1), cond)
        return {"x": out[..., :xc], "y": resize_bilinear(out[..., xc:], gt // self.scale)}


@register_model(name="ddpm_multi_speed_haar")
class DDPMMultiSpeedHaar(nn.Module):
    """A DDPM on Haar coefficients: a dict ``{'d1', ..., 'dK', 'aK'}`` of
    detail and approximation bands goes back to the image, through the
    U-Net, and out as the same dict.  The JAX package's working form of a
    model that its reference left unfinished; this copies the JAX one."""

    def __init__(self, unet: DDPM, max_haar_depth: int = 1):
        super().__init__()
        self.unet, self.max_haar_depth = unet, max_haar_depth

    @classmethod
    def from_config(cls, config):
        return cls(DDPM.from_config(config), config.data.get("max_haar_depth", 1))

    def forward(self, haar_x, cond):
        depth = max(int(k[1:]) for k in haar_x if k.startswith("a"))
        a = haar_x[f"a{depth}"]
        for i in range(depth, 0, -1):
            a = haar_backward(torch.cat([a, haar_x[f"d{i}"]], dim=-1))
        x = self.unet(a, cond)
        C = x.shape[-1]
        result = {}
        for i in range(1, depth + 1):
            z = haar_forward(x)
            x = z[..., :C]
            result[f"d{i}"] = z[..., C:]
        result[f"a{depth}"] = x
        return result
