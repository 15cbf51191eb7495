"""NCSN++ U-Net and its paired variants in PyTorch, NHWC (JAX
`models/ncsnpp.py`: `ncsnpp`, `ncsnpp_paired`, `ncsnpp_paired_SR3`,
`ncsnpp_2xSR`, `ncsnpp_KxSR`).

Fourier or positional time embedding, BigGAN or DDPM resblocks, FIR
resampling, progressive input and output pyramids (``input_skip`` /
``output_skip`` / ``residual``, combined by sum or concat), attention at the
configured resolutions and the 1/sqrt(2) skip rescale.  Submodules carry the
JAX module names (``fourier``, ``conv_in``, ``down_0_0``, ``down_0``,
``pyr_down_0``, ``combine_0``, ``mid_attn``, ``up_5_2``, ``pyr_norm_5``,
``pyr_conv_5``, ``pyr_up_4``, ...), so a ``state_dict`` key is the Flax
parameter path with the leaf renamed.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import register_model
from .ddpm import _ACTS, squeeze2x
from .layers import INV_SQRT2, Conv3x3, Dense, get_timestep_embedding
from .layerspp import (
    AttnBlockpp,
    Combine,
    Downsample,
    GaussianFourierProjection,
    ResnetBlockBigGANpp,
    ResnetBlockDDPMpp,
    Upsample,
    group_norm,
)


@register_model(name="ncsnpp")
class NCSNpp(nn.Module):
    """NCSN++ on NHWC input; ``forward(x, time_cond)``."""

    def __init__(
        self,
        nf: int,
        ch_mult: Sequence[int],
        num_res_blocks: int,
        attn_resolutions: Sequence[int],
        dropout: float,
        resamp_with_conv: bool,
        image_size: int,
        conditional: bool,
        centered: bool,
        channels: int,
        fir: bool,
        fir_kernel: Sequence[float],
        skip_rescale: bool,
        resblock_type: str,
        progressive: str,
        progressive_input: str,
        embedding_type: str,
        init_scale: float,
        fourier_scale: float,
        combine_method: str,
        nonlinearity: str = "swish",
        split_skip_convs: bool = False,
        fused_tail: bool = False,
        fused_block: bool = False,
    ):
        super().__init__()
        if progressive not in ("none", "output_skip", "residual"):
            raise ValueError(f"progressive {progressive!r} unknown")
        if progressive_input not in ("none", "input_skip", "residual"):
            raise ValueError(f"progressive_input {progressive_input!r} unknown")
        if embedding_type not in ("fourier", "positional"):
            raise ValueError(f"embedding type {embedding_type!r} unknown")
        self.act = act = _ACTS[nonlinearity]
        self.nf, self.num_levels, self.num_res_blocks = nf, len(ch_mult), num_res_blocks
        self.attn_resolutions, self.conditional, self.centered = tuple(attn_resolutions), conditional, centered
        self.skip_rescale, self.resblock_type = skip_rescale, resblock_type
        self.progressive, self.progressive_input, self.embedding_type = progressive, progressive_input, embedding_type

        temb_dim = None
        if embedding_type == "fourier":
            self.fourier = GaussianFourierProjection(embedding_size=nf, scale=fourier_scale)
        if conditional:
            self.temb0 = Dense(2 * nf if embedding_type == "fourier" else nf, nf * 4)
            self.temb1 = Dense(nf * 4, nf * 4)
            temb_dim = nf * 4

        def resblock(in_ch, out_ch=None, up=False, down=False, split=False):
            common = dict(
                temb_dim=temb_dim, dropout=dropout, init_scale=init_scale, skip_rescale=skip_rescale,
                split_skip=split, fused_tail=fused_tail, fused_block=fused_block,
            )
            if resblock_type == "ddpm":
                if up or down:
                    raise ValueError("DDPM resblocks do not resample")
                return ResnetBlockDDPMpp(act, in_ch, out_ch, **common)
            return ResnetBlockBigGANpp(act, in_ch, out_ch, up=up, down=down, fir=fir, fir_kernel=fir_kernel, **common)

        def attn(ch):
            return AttnBlockpp(ch, skip_rescale=skip_rescale, init_scale=init_scale)

        # Build in the order of `forward`, keeping the channel counts.
        self.conv_in = Conv3x3(channels, nf)
        hs_ch, ch, res, pyr_ch = [nf], nf, image_size, channels
        for i_level in range(self.num_levels):
            for i_block in range(num_res_blocks):
                out_ch = nf * ch_mult[i_level]
                self.add_module(f"down_{i_level}_{i_block}", resblock(ch, out_ch))
                ch = out_ch
                if res in self.attn_resolutions:
                    self.add_module(f"down_attn_{i_level}_{i_block}", attn(ch))
                hs_ch.append(ch)
            if i_level != self.num_levels - 1:
                if resblock_type == "ddpm":
                    down = Downsample(ch, ch, with_conv=resamp_with_conv, fir=fir, fir_kernel=fir_kernel)
                else:
                    down = resblock(ch, down=True)
                self.add_module(f"down_{i_level}", down)
                if progressive_input == "input_skip":
                    self.add_module(f"pyr_down_{i_level}", Downsample(pyr_ch, pyr_ch, fir=fir, fir_kernel=fir_kernel))
                    self.add_module(f"combine_{i_level}", Combine(pyr_ch, ch, method=combine_method))
                    ch = 2 * ch if combine_method == "cat" else ch
                elif progressive_input == "residual":
                    self.add_module(
                        f"pyr_down_{i_level}",
                        Downsample(pyr_ch, ch, with_conv=True, fir=fir, fir_kernel=fir_kernel),
                    )
                    pyr_ch = ch
                hs_ch.append(ch)
                res //= 2

        self.mid_block0 = resblock(ch)
        self.mid_attn = attn(ch)
        self.mid_block1 = resblock(ch)

        for i_level in reversed(range(self.num_levels)):
            for i_block in range(num_res_blocks + 1):
                out_ch = nf * ch_mult[i_level]
                self.add_module(
                    f"up_{i_level}_{i_block}", resblock(ch + hs_ch.pop(), out_ch, split=split_skip_convs)
                )
                ch = out_ch
            if res in self.attn_resolutions:
                self.add_module(f"up_attn_{i_level}", attn(ch))
            if progressive == "output_skip":
                if i_level != self.num_levels - 1:
                    self.add_module(f"pyr_up_{i_level}", Upsample(channels, channels, fir=fir, fir_kernel=fir_kernel))
                self.add_module(f"pyr_norm_{i_level}", group_norm(ch))
                self.add_module(f"pyr_conv_{i_level}", Conv3x3(ch, channels, init_scale=init_scale))
            elif progressive == "residual":
                if i_level == self.num_levels - 1:
                    self.add_module(f"pyr_norm_{i_level}", group_norm(ch))
                    self.add_module(f"pyr_conv_{i_level}", Conv3x3(ch, ch))
                else:
                    self.add_module(
                        f"pyr_up_{i_level}",
                        Upsample(pyr_ch, ch, with_conv=True, fir=fir, fir_kernel=fir_kernel),
                    )
                pyr_ch = ch
            if i_level != 0:
                if resblock_type == "ddpm":
                    up = Upsample(ch, ch, with_conv=resamp_with_conv, fir=fir, fir_kernel=fir_kernel)
                else:
                    up = resblock(ch, up=True)
                self.add_module(f"up_{i_level}", up)
                res *= 2
        if hs_ch:
            raise AssertionError("unconsumed skip connections")

        if progressive != "output_skip":
            self.norm_out = group_norm(ch)
            self.conv_out = Conv3x3(ch, channels, init_scale=init_scale)

    @classmethod
    def from_config(cls, config):
        m = config.model
        return cls(
            nf=m.nf,
            ch_mult=tuple(m.ch_mult),
            num_res_blocks=m.num_res_blocks,
            attn_resolutions=tuple(m.attn_resolutions),
            dropout=m.dropout,
            resamp_with_conv=m.resamp_with_conv,
            image_size=config.data.effective_image_size,
            conditional=m.conditional,
            centered=config.data.centered,
            channels=config.data.num_channels,
            fir=m.fir,
            fir_kernel=tuple(m.fir_kernel),
            skip_rescale=m.skip_rescale,
            resblock_type=m.resblock_type.lower(),
            progressive=m.progressive.lower(),
            progressive_input=m.progressive_input.lower(),
            embedding_type=m.embedding_type.lower(),
            init_scale=m.init_scale,
            fourier_scale=m.fourier_scale,
            combine_method=m.progressive_combine.lower(),
            nonlinearity=m.nonlinearity.lower(),
            split_skip_convs=m.get("split_skip_convs", True),
            fused_tail=m.get("fused_tail", False),
            fused_block=m.get("fused_block", False),
        )

    def _resample(self, name, h, temb):
        """The level's x2 resampler: a resblock (BigGAN) or a layer."""
        layer = getattr(self, name)
        return layer(h) if self.resblock_type == "ddpm" else layer(h, temb)

    def forward(self, x, time_cond):
        act = self.act
        if self.embedding_type == "fourier":
            temb = self.fourier(time_cond)
        else:
            temb = get_timestep_embedding(time_cond, self.nf)
        # the float32 embedding in the activations' dtype, as in JAX
        temb = temb.to(x.dtype)
        if self.conditional:
            temb = self.temb1(act(self.temb0(temb)))
        else:
            temb = None

        if not self.centered:
            x = 2 * x - 1.0
        input_pyramid = x if self.progressive_input != "none" else None
        hs = [self.conv_in(x)]
        for i_level in range(self.num_levels):
            for i_block in range(self.num_res_blocks):
                h = getattr(self, f"down_{i_level}_{i_block}")(hs[-1], temb)
                if h.shape[1] in self.attn_resolutions:
                    h = getattr(self, f"down_attn_{i_level}_{i_block}")(h)
                hs.append(h)
            if i_level != self.num_levels - 1:
                h = self._resample(f"down_{i_level}", hs[-1], temb)
                if self.progressive_input == "input_skip":
                    input_pyramid = getattr(self, f"pyr_down_{i_level}")(input_pyramid)
                    h = getattr(self, f"combine_{i_level}")(input_pyramid, h)
                elif self.progressive_input == "residual":
                    input_pyramid = getattr(self, f"pyr_down_{i_level}")(input_pyramid)
                    input_pyramid = (input_pyramid + h) * INV_SQRT2 if self.skip_rescale else input_pyramid + h
                    h = input_pyramid
                hs.append(h)

        h = hs[-1]
        h = self.mid_block0(h, temb)
        h = self.mid_attn(h)
        h = self.mid_block1(h, temb)

        pyramid = None
        for i_level in reversed(range(self.num_levels)):
            for i_block in range(self.num_res_blocks + 1):
                h = getattr(self, f"up_{i_level}_{i_block}")(h, temb, skip=hs.pop())
            if h.shape[1] in self.attn_resolutions:
                h = getattr(self, f"up_attn_{i_level}")(h)
            if self.progressive != "none":
                top = i_level == self.num_levels - 1
                if not top:
                    pyramid = getattr(self, f"pyr_up_{i_level}")(pyramid)
                if self.progressive == "output_skip":
                    pyr_h = getattr(self, f"pyr_norm_{i_level}")(h)
                    pyr_h = getattr(self, f"pyr_conv_{i_level}")(act(pyr_h))
                    pyramid = pyr_h if top else pyramid + pyr_h
                elif top:  # residual
                    pyramid = getattr(self, f"pyr_conv_{i_level}")(act(getattr(self, f"pyr_norm_{i_level}")(h)))
                else:
                    pyramid = (pyramid + h) * INV_SQRT2 if self.skip_rescale else pyramid + h
                    h = pyramid
            if i_level != 0:
                h = self._resample(f"up_{i_level}", h, temb)

        if self.progressive == "output_skip":
            return pyramid
        return self.conv_out(act(self.norm_out(h)))


class _Paired(nn.Module):
    """A paired (x, y) model around one NCSN++ (param ``unet``)."""

    def __init__(self, unet: NCSNpp):
        super().__init__()
        self.unet = unet

    @classmethod
    def from_config(cls, config):
        return cls(NCSNpp.from_config(config))


@register_model(name="ncsnpp_paired")
class NCSNppPaired(_Paired):
    """Joint score of (x, y): concat on channels, split the output."""

    def forward(self, inputs, cond):
        x, y = inputs["x"], inputs["y"]
        xc = x.shape[-1]
        out = self.unet(torch.cat([x, y], dim=-1), cond)
        return {"x": out[..., :xc], "y": out[..., xc:]}


@register_model(name="ncsnpp_paired_SR3")
class NCSNppPairedSR3(_Paired):
    """SR3 form: the score of x only, the clean y as input."""

    def forward(self, inputs, cond):
        return self.unet(torch.cat([inputs["x"], inputs["y"]], dim=-1), cond)


@register_model(name="ncsnpp_2xSR")
class NCSNpp2xSR(_Paired):
    """x space-to-depth by 2 beside the half-size y."""

    def forward(self, inputs, cond):
        xs = squeeze2x(inputs["x"])
        xc = xs.shape[-1]
        out = self.unet(torch.cat([xs, inputs["y"]], dim=-1), cond)
        return {"x": squeeze2x(out[..., :xc], reverse=True), "y": out[..., xc:]}


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear resize of NHWC ``x`` to ``size`` x ``size``, antialiased when
    it shrinks, as `jax.image.resize(..., "bilinear")`; computed in float32."""
    h = F.interpolate(
        x.permute(0, 3, 1, 2).float(), size=(size, size), mode="bilinear", align_corners=False, antialias=True
    )
    return h.permute(0, 2, 3, 1).to(x.dtype)


@register_model(name="ncsnpp_KxSR")
class NCSNppKxSR(_Paired):
    """K x super-resolution: y (target/scale) resized bilinearly up to x's
    size as input, the y score resized back down."""

    def __init__(self, unet: NCSNpp, target_resolution: int, scale: int):
        super().__init__(unet)
        self.target_resolution, self.scale = target_resolution, scale

    @classmethod
    def from_config(cls, config):
        return cls(NCSNpp.from_config(config), config.data.target_resolution, config.data.scale)

    def forward(self, inputs, cond):
        x, y = inputs["x"], inputs["y"]
        gt = self.target_resolution
        xc = x.shape[-1]
        out = self.unet(torch.cat([x, resize_bilinear(y, gt)], dim=-1), cond)
        return {"x": out[..., :xc], "y": resize_bilinear(out[..., xc:], gt // self.scale)}
