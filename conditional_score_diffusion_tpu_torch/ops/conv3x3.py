"""3x3 SAME stride-1 convolution (+ bias), NHWC, with an autograd backward.

Port of `conditional_score_diffusion_tpu/ops/conv_pallas.py`:
`conv3x3_pallas` (:198; Pallas kernel `_conv_kernel`, pallas_call :90) and
`conv3x3_hmajor` (:144, pallas_call :159), the same conv on an (H, W, B, C)
layout.  Both are one CUDA kernel, `csrc/conv3x3.cu` (its header says what
bounds it on the card and what its design does about that), which takes the
element strides of (b, h, w): :func:`conv3x3_hmajor` is the same launch as
:func:`conv3x3` with other strides, with no transposes.  `ops/nvcc.py`
builds it for sm_90a into `_build/` at first use; it is called through
ctypes.

The gradient (:class:`Conv3x3Function`, the counterpart of the JAX
`custom_vjp`):

* ``dx`` is itself a 3x3 SAME stride-1 conv: of the output gradient, with
  the weights rotated by 180 degrees and Cin/Cout swapped
  (``w.flip(2, 3).transpose(0, 1)`` in OIHW).  The backward launches the
  same kernel for it.
* ``dW`` goes to `torch.nn.grad.conv2d_weight` (cuDNN on the card).  The
  JAX `_bwd` (:207-213) leaves both gradients to XLA, so there is no TPU
  backward kernel to port; a product that JAX leaves to XLA may stay a
  library call.
* ``db`` is the output gradient summed over pixels.

``ctx.needs_input_grad`` is honoured: no ``dx`` launch is made for an input
that needs no gradient (the network's first conv).

:func:`conv3x3` and :func:`conv3x3_hmajor` check their arguments on both
devices, then take the plain version (:func:`conv3x3_plain`,
:func:`conv3x3_hmajor_plain`: `F.conv2d` on the NCHW view) for a CPU tensor
and launch the kernel for a CUDA tensor; there is no other path.
``conv3x3.launches`` counts the kernel's launches from :func:`conv3x3`, the
backward's ``dx`` launches included; ``conv3x3_hmajor.launches`` those from
the (H, W, B, C) entry.

Layouts: ``x`` NHWC (or (H, W, B, C) for the hmajor entry), contiguous;
``w`` OIHW (PyTorch's conv layout; the JAX functions take HWIO), of
``x``'s dtype; ``bias`` float32 (Cout,) or None.  ``x`` float32 or bfloat16;
the sums are float32 and the output, in ``x``'s dtype, is rounded once.

:func:`launch_plan` is the launch plan of the 3x3 main loop
(`csrc/conv3x3_core.cuh`) that this kernel, the fused tail
(`ops/fused_tail.py`) and the whole-resblock kernels (`ops/fused_block.py`)
share: tile, stages, split-K count (the size of the thread-block cluster),
copy widths, shared memory.  It is computed here,
on the host, so the CPU tests reach it; the C entries check it against
what they compiled.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import nvcc
from .forward_only import forward_only
from .fused_tail import DTYPES, check_arg, check_input
from .nvcc import KernelLibrary

INT32_LIMIT = 2**31  # the kernel indexes with 32-bit integers
SM_COUNT = 132  # streaming multiprocessors of an H100 SXM: one wave of blocks
MAX_SPLITS = 8  # split-K blocks of one thread-block cluster (the portable cluster size)
SMEM_LIMIT = 232_448  # dynamic shared memory a block may have on sm_90 (227 KB)
# The compiled tile configurations of `csrc/conv3x3_core.cuh`, by element
# type and tile width BN: (BM, BK, stages, blocks an SM holds).  The
# narrowest serves Cout up to its width.  float32 on the CUDA cores,
# bfloat16 on the tensor cores, where 64-row tiles serve the tails' widths
# (twice the blocks of 128-row ones on the small sampler problems).
TILES = {
    torch.float32: {96: (128, 16, 4, 2), 64: (128, 16, 4, 2), 8: (512, 16, 3, 1)},
    torch.bfloat16: {128: (64, 64, 3, 2), 96: (64, 64, 3, 2), 64: (128, 64, 3, 2), 16: (128, 64, 3, 2)},
}
# Split-K: the counts a cluster may have (clusters of 5 and 7 blocks pack
# the GPCs badly: 8x20x20x192 float32 took 0.11 ms split 5 ways, 0.087 ms 4
# ways), and the fewest K values a split should sum where the splits put two
# blocks on an SM (below it the split's pipeline fill and the cluster
# reduction cost more than the split saves: 16x16x16x128 float32 took 0.050
# ms split 2 ways, 0.065 ms 4 ways).  Both measured on an NVIDIA H100 80GB
# HBM3 at 700 W.
SPLIT_COUNTS = (2, 3, 4, 6, 8)
MIN_SPLIT_K = 320


class LaunchPlan(NamedTuple):
    """One launch of the 3x3 main loop; see :func:`launch_plan`."""

    bm: int
    bn: int
    bk: int
    stages: int
    splits: int  # blocks that share one output tile's K chunks: one thread-block cluster
    smem: int  # dynamic shared memory bytes a block
    a_vec: int  # 1: 16-byte copies of x along channels; 0: one element a copy
    b_vec: int  # the same for the weights along output channels
    mtiles: int
    ntiles: int
    nchunks: int  # BK-wide chunks of K = 9 * Cin + extra

    def c_args(self):
        """The ints the C entries take, in their order."""
        return (self.bm, self.bn, self.bk, self.stages, self.splits, self.smem, self.a_vec, self.b_vec)


def launch_plan(
    M: int, Cin: int, Cout: int, dtype: torch.dtype, x_aligned: bool = True, extra: int = 0
) -> LaunchPlan:
    """The plan of one main-loop launch over ``M`` pixels, ``Cin`` -> ``Cout``,
    K = 9 * ``Cin`` + ``extra`` (the whole-resblock's conv1 folds its
    channel-mix shortcut into ``extra`` more K columns).

    The tile width BN wastes the fewest output columns (the wider on a tie;
    the narrow tile for Cout up to its width).  Copies are 16 bytes where a
    pixel's channels (``Cin``; ``x_aligned``: x's address too, and whatever
    the ``extra`` columns read) or a weight row (``Cout``) are whole 16-byte
    vectors.  Where the M x N tiles are fewer than the SMs, K's chunks are
    split over ``splits`` >= 2 blocks of one cluster: the largest of
    :data:`SPLIT_COUNTS` whose blocks fit the SMs in one wave and, where
    they take two blocks an SM, sum :data:`MIN_SPLIT_K` K values or more
    each; at most :data:`MAX_SPLITS` and one per chunk.  The shared memory
    holds the stages' A and B tiles, or the float32 output tile of the
    epilogue, whichever is larger.
    """
    configs = TILES[dtype]
    narrow = min(configs)
    if Cout <= narrow:
        bn = narrow
    else:
        bn = min((b for b in configs if b != narrow), key=lambda b: (-(-Cout // b) * b - Cout, -b))
    bm, bk, stages, per_sm = configs[bn]
    item = 4 if dtype == torch.float32 else 2
    pad_a, pad_b = (4, 0) if dtype == torch.float32 else (8, 8)
    stage_bytes = (bm * (bk + pad_a) + bk * (bn + pad_b)) * item
    smem = max(stages * stage_bytes, bm * (bn + 4) * 4)
    vec = 16 // item
    K = 9 * Cin + extra
    mtiles, ntiles, nchunks = -(-M // bm), -(-Cout // bn), -(-K // bk)
    max_splits = min(MAX_SPLITS, nchunks)
    tiles, splits = mtiles * ntiles, 1
    if tiles < SM_COUNT and max_splits > 1:
        fits = [
            s for s in SPLIT_COUNTS
            if s <= max_splits and tiles * s <= SM_COUNT * per_sm
            and (tiles * s <= SM_COUNT or K >= s * MIN_SPLIT_K)
        ]
        splits = max(fits, default=2)
    return LaunchPlan(
        bm, bn, bk, stages, splits, smem, int(Cin % vec == 0 and x_aligned), int(Cout % vec == 0),
        mtiles, ntiles, nchunks,
    )


def split_k_ranges(plan: LaunchPlan, Cin: int, extra: int = 0):
    """The [k0, k1) range of K = 9 * Cin + extra (k = tap * Cin + channel,
    then the extra columns) that each split of ``plan`` sums, in rank order,
    as the kernel cuts it."""
    K, n, s = 9 * Cin + extra, plan.nchunks, plan.splits
    return [(r * n // s * plan.bk, min(K, (r + 1) * n // s * plan.bk)) for r in range(s)]


def hwio(w: torch.Tensor) -> torch.Tensor:
    """OIHW ``w`` as the main loop's B operand: (3, 3, Cin, Cout), contiguous."""
    return w.permute(2, 3, 1, 0).contiguous()


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same function in plain PyTorch: `F.conv2d` (padding 1) on the
    NCHW view of NHWC ``x``; in bfloat16 the products are summed in float32
    with the bias and rounded once, as the kernel does."""
    if x.dtype == torch.float32:
        y = F.conv2d(x.permute(0, 3, 1, 2), w, bias, padding=1)
    else:
        y = F.conv2d(x.permute(0, 3, 1, 2).float(), w.float(), bias, padding=1).to(x.dtype)
    return y.permute(0, 2, 3, 1)


def conv3x3_hmajor_plain(xt: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`conv3x3_plain` of (H, W, B, C) ``xt``; (H, W, B, Cout) out."""
    return conv3x3_plain(xt.permute(2, 0, 1, 3), w, bias).permute(1, 2, 0, 3)


@functools.cache
def load_library() -> KernelLibrary:
    """Build ``csrc/conv3x3.cu`` (once per source content) and load it."""
    built = nvcc.build("conv3x3")
    built.lib.conv3x3_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 20 + [ctypes.c_void_p]
    built.lib.conv3x3_launch.restype = ctypes.c_int
    built.lib.conv3x3_error_string.argtypes = [ctypes.c_int]
    built.lib.conv3x3_error_string.restype = ctypes.c_char_p
    return built


def _check(name: str, x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    """What the kernel takes: ``x`` float32 or bfloat16, 4-D, contiguous,
    under 2**31 elements; ``w`` (Cout, Cin, 3, 3) of x's dtype on x's
    device; ``bias`` float32 (Cout,), contiguous."""
    check_input(name, x)
    check_arg("x", x, x.device, x.dtype, x.shape)
    Cin = x.shape[-1]
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if w.dtype != x.dtype:
        raise TypeError(f"w must be {x.dtype}, got {w.dtype}")
    if w.ndim != 4 or tuple(w.shape[1:]) != (Cin, 3, 3):
        raise ValueError(f"w must have shape (Cout, {Cin}, 3, 3), got {tuple(w.shape)}")
    if bias is not None:
        check_arg("bias", bias, x.device, torch.float32, (w.shape[0],))
    if x.numel() // Cin * max(Cin, w.shape[0]) >= INT32_LIMIT:
        raise ValueError(f"{name}: {tuple(x.shape)} -> {w.shape[0]} channels needs 64-bit indices")


def _launch(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], dims, x_strides, out: torch.Tensor, out_strides):
    """One kernel launch: ``dims`` = (B, H, W, Cin, Cout), strides of
    (b, h, w) in elements."""
    lib = load_library().lib
    B, H, W, Cin, Cout = dims
    plan = launch_plan(B * H * W, Cin, Cout, x.dtype, x_aligned=x.data_ptr() % 16 == 0)
    w_kn = hwio(w)  # referenced until the launch is enqueued
    err = lib.conv3x3_launch(
        x.data_ptr(), w_kn.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
        *dims, *x_strides, *out_strides, DTYPES[x.dtype], *plan.c_args(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        msg = lib.conv3x3_error_string(err).decode()
        raise RuntimeError(f"conv3x3 launch failed: CUDA error {err} ({msg})")
    return out


def _conv3x3_nhwc(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The checked forward on NHWC ``x``: plain on the CPU, the kernel on CUDA."""
    _check("conv3x3", x, w, bias)
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, bias)
    B, H, W, Cin = x.shape
    Cout = w.shape[0]
    out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
    _launch(x, w, bias, (B, H, W, Cin, Cout), (H * W * Cin, W * Cin, Cin), out, (H * W * Cout, W * Cout, Cout))
    conv3x3.launches += 1
    return out


class Conv3x3Function(torch.autograd.Function):
    """:func:`conv3x3` with its gradient (see the module docstring)."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        ctx.has_bias = bias is not None
        return _conv3x3_nhwc(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _conv3x3_nhwc(g, w.flip(2, 3).transpose(0, 1), None)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(x.permute(0, 3, 1, 2), w.shape, g.permute(0, 3, 1, 2), padding=1)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = g.float().sum(dim=(0, 1, 2))
        return dx, dw, db


def conv3x3(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """3x3 SAME stride-1 conv of NHWC ``x`` with OIHW ``w`` (+ float32
    ``bias``), NHWC out, differentiable in ``x``, ``w`` and ``bias``."""
    return Conv3x3Function.apply(x, w, bias)


def conv3x3_hmajor(xt: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same conv on an (H, W, B, C) tensor, (H, W, B, Cout) out: the
    kernel of :func:`conv3x3` launched with this layout's strides.  Forward
    only, as the JAX function is: a backward through it raises."""
    _check("conv3x3_hmajor", xt, w, bias)
    if xt.device.type == "cpu":
        return forward_only("conv3x3_hmajor", lambda: conv3x3_hmajor_plain(xt, w, bias), (xt, w, bias))
    H, W, B, Cin = xt.shape
    Cout = w.shape[0]

    def run():
        out = torch.empty((H, W, B, Cout), dtype=xt.dtype, device=xt.device)
        _launch(xt, w, bias, (B, H, W, Cin, Cout), (Cin, W * B * Cin, B * Cin), out, (Cout, W * B * Cout, B * Cout))
        conv3x3_hmajor.launches += 1
        return out

    return forward_only("conv3x3_hmajor", run, (xt, w, bias))


conv3x3.launches = 0
conv3x3_hmajor.launches = 0
