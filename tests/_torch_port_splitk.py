"""A plain-PyTorch emulation of the split-K partition of the 3x3 main loop
(`csrc/conv3x3_core.cuh`), shared by the conv3x3 and fused-tail tests.

The kernel sums A[m, k] * B[k, n] over K = 9 * Cin (k = tap * Cin + channel)
in `split_k_ranges(plan, Cin)` pieces, one per block of a cluster, then adds
the pieces in rank order and the bias and temb once.  Here each piece is an
im2col product over its K range, in float32.
"""

import torch
import torch.nn.functional as F

from conditional_score_diffusion_tpu_torch.ops.conv3x3 import hwio, split_k_ranges


def im2col(a: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 9 * C) of NHWC ``a``: column tap * C + c holds
    a[b, y + dy - 1, x + dx - 1, c] for tap = 3 * dy + dx, 0 outside."""
    B, H, W, C = a.shape
    p = F.pad(a, (0, 0, 1, 1, 1, 1))
    return torch.cat([p[:, dy:dy + H, dx:dx + W, :] for dy in range(3) for dx in range(3)], dim=-1)


def split_k_conv(a, w, plan, bias=None, temb=None):
    """The kernel's sum: per-split partial products over the plan's K ranges,
    added in rank order, then bias and temb; float32 out."""
    cols = im2col(a.float())
    w_kn = hwio(w.float()).reshape(-1, w.shape[0])
    out = torch.zeros(*a.shape[:-1], w.shape[0])
    for k0, k1 in split_k_ranges(plan, a.shape[-1]):
        out = out + cols[..., k0:k1] @ w_kn[k0:k1]
    if bias is not None:
        out = out + bias.float()
    if temb is not None:
        out = out + temb.float()[:, None, None, :]
    return out


def check_plan(M, Cin, Cout, dtype):
    """The launch plan of one main-loop call, held to what the kernel needs:
    every (tap, channel) of K in exactly one split, at most 8 splits (the
    blocks of one cluster), grids under one wave split, the shared
    memory within the SM's 227 KB; returns the plan."""
    from conditional_score_diffusion_tpu_torch.ops import conv3x3 as ops

    plan = ops.launch_plan(M, Cin, Cout, dtype)
    K = 9 * Cin
    ranges = ops.split_k_ranges(plan, Cin)
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
