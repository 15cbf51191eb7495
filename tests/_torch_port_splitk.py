"""A plain-PyTorch emulation of the split-K partition of the 3x3 main loop
(`csrc/conv3x3_core.cuh`), shared by the conv3x3, fused-tail and
whole-resblock tests.

The kernel sums A[m, k] * B[k, n] over K = 9 * Cin (k = tap * Cin + channel)
in `split_k_ranges(plan, Cin)` pieces, one per block of a cluster, then adds
the pieces in rank order and the bias and temb once.  Here each piece is an
im2col product over its K range, in float32.  The whole-resblock's conv1
runs K on past the 9 taps into the block's input at the output pixel (the
folded channel-mix shortcut, `extra` columns).
"""

import math

import torch
import torch.nn.functional as F

from conditional_score_diffusion_tpu_torch.ops.conv3x3 import hwio, split_k_ranges
from conditional_score_diffusion_tpu_torch.ops.fused_block import block_plans, pack_conv1
from conditional_score_diffusion_tpu_torch.ops.fused_tail import group_norm_stats


def im2col(a: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 9 * C) of NHWC ``a``: column tap * C + c holds
    a[b, y + dy - 1, x + dx - 1, c] for tap = 3 * dy + dx, 0 outside."""
    B, H, W, C = a.shape
    p = F.pad(a, (0, 0, 1, 1, 1, 1))
    return torch.cat([p[:, dy:dy + H, dx:dx + W, :] for dy in range(3) for dx in range(3)], dim=-1)


def split_k_sum(cols, w_kn, plan, Cin, extra=0):
    """sum_k cols[..., k] * w_kn[k] as the kernel cuts K: one partial
    product per split over its range, added in rank order; float32."""
    out = torch.zeros(*cols.shape[:-1], w_kn.shape[1])
    for k0, k1 in split_k_ranges(plan, Cin, extra):
        out = out + cols[..., k0:k1] @ w_kn[k0:k1]
    return out


def split_k_conv(a, w, plan, bias=None, temb=None):
    """The kernel's sum: per-split partial products over the plan's K ranges,
    added in rank order, then bias and temb; float32 out."""
    out = split_k_sum(im2col(a.float()), hwio(w.float()).reshape(-1, w.shape[0]), plan, a.shape[-1])
    if bias is not None:
        out = out + bias.float()
    if temb is not None:
        out = out + temb.float()[:, None, None, :]
    return out


def gn_silu(x, gamma, beta, num_groups):
    """silu(GroupNorm(x)) of NHWC ``x``, float32: the GroupNorm pass."""
    mean, rstd = group_norm_stats(x, num_groups)
    scale = rstd * gamma
    return F.silu(x.float() * scale[:, None, None, :] + (beta - mean * scale)[:, None, None, :])


def split_k_block(x, skip, kw):
    """The whole-resblock kernel's four launches in float32: the GroupNorm
    pass over cat(x, skip), conv0 split over its plan (+ b0 + temb) into
    float32 h, the pass over h, then conv1 with the shortcut folded into K:
    im2col(a1) and, for a channel mix, cat(x, skip) at the output pixel,
    against `pack_conv1(w1, shortcut_w)`, split over its plan; + b1 (+ bs),
    + the identity residual, x the rescale."""
    xc = x if skip is None else torch.cat([x, skip], dim=-1)
    B, H, W, Cin = xc.shape
    Cout, ws = kw["w0"].shape[0], kw["shortcut_w"]
    plan0, plan1 = block_plans(B, H, W, x.shape[-1], Cin - x.shape[-1], Cout, torch.float32, ws is not None)
    a0 = gn_silu(xc, kw["gamma0"], kw["beta0"], kw["num_groups0"])
    h = split_k_conv(a0, kw["w0"], plan0, kw["b0"], kw["temb_proj"])
    a1 = gn_silu(h, kw["gamma1"], kw["beta1"], kw["num_groups1"])
    cols = im2col(a1) if ws is None else torch.cat([im2col(a1), xc.float()], dim=-1)
    out = split_k_sum(cols, pack_conv1(kw["w1"].float(), None if ws is None else ws.float()), plan1, Cout,
                      0 if ws is None else Cin)
    bias1 = kw["b1"] if kw["shortcut_b"] is None else kw["b1"] + kw["shortcut_b"]
    out = out + bias1
    if ws is None:
        out = xc.float() + out
    return out * (1.0 / math.sqrt(2.0) if kw["skip_rescale"] else 1.0)


def check_plan(M, Cin, Cout, dtype, extra=0, x_aligned=True):
    """The launch plan of one main-loop call, held to what the kernel needs:
    every (tap, channel) of K (and the ``extra`` columns) in exactly one
    split, at most 8 splits (the blocks of one cluster), grids under one
    wave split, the shared memory within the SM's 227 KB; returns the
    plan."""
    from conditional_score_diffusion_tpu_torch.ops import conv3x3 as ops

    plan = ops.launch_plan(M, Cin, Cout, dtype, x_aligned, extra)
    K = 9 * Cin + extra
    ranges = ops.split_k_ranges(plan, Cin, extra)
    assert len(ranges) == plan.splits and ranges[0][0] == 0 and ranges[-1][1] == K
    assert all(k0 < k1 for k0, k1 in ranges) and all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(k0 % plan.bk == 0 for k0, _ in ranges)  # whole chunks, as the kernel cuts them
    assert 1 <= plan.splits <= ops.MAX_SPLITS
    if plan.mtiles * plan.ntiles < ops.SM_COUNT and plan.nchunks > 1:
        assert plan.splits > 1
    assert plan.smem <= ops.SMEM_LIMIT
    assert plan.bn in ops.TILES[dtype] and (plan.bm, plan.bk, plan.stages) == ops.TILES[dtype][plan.bn][:3]
    assert plan.mtiles * plan.bm >= M and plan.ntiles * plan.bn >= Cout and plan.nchunks * plan.bk >= K
    return plan
