"""A whole DDPM resblock in eval mode as one kernel call, and its split-skip
decoder variant on the virtual concat cat(x, skip).

Port of `conditional_score_diffusion_tpu/ops/fused_block_pallas.py`:
`resblock_fused_lowres` (:269, Pallas kernel `_resblock_kernel` :204) and
`resblock_fused_lowres_split` (:462, `_resblock_split_kernel` :384).  Both
CUDA kernels are in `csrc/resblock_fused.cu` (its header says what bounds
them on the card and what the design does about that): a call is four
launches, a GroupNorm+SiLU pass (`csrc/gn_silu_act.cuh`) and a 3x3 conv on
the main loop that kernel 4 and the fused tail share
(`csrc/conv3x3_core.cuh`), twice; conv1 folds the channel-mix shortcut
into its K.  `ops/nvcc.py` builds it for sm_90a into `_build/` at first
use, and it is called through ctypes.

The weights go to the kernel packed as the main loop's B operands, once per
weight (`ops.fused_tail.packed_operand`): ``w0`` as (3, 3, Cin, Cout),
``w1`` as (3, 3, Cout, Cout) with ``shortcut_w`` stacked under it along K
(:func:`pack_conv1`).  Each conv's launch plan is `ops.conv3x3.launch_plan`'s
(:func:`block_plans`).

:func:`resblock_fused` and :func:`resblock_fused_split` check their
arguments, then take the plain version (:func:`resblock_fused_plain`,
:func:`resblock_fused_split_plain`) for CPU tensors and launch the kernel
for CUDA tensors; there is no other path.  ``.launches`` on each wrapper
counts its kernel's launches.  The kernels have no backward (eval only, as
in JAX): where a gradient could flow, the call goes through
`ops.forward_only`, whose backward raises.

The block, in eval mode (dropout is the identity)::

    h   = conv3x3(silu(GN0(x)), w0) + b0 + temb_proj[:, None, None]
    h   = conv3x3(silu(GN1(h)), w1) + b1
    out = (shortcut(x) + h) * (1/sqrt(2) if skip_rescale else 1)

in the TPU kernel's precision, which is not that of the unfused block in
bfloat16: GroupNorm statistics in float32, each activation rounded to the
weights' dtype before its conv, float32 sums, ``h`` kept in float32 between
conv0 and GN1, ``b0 + temb_proj`` folded into one float32 (B, Cout) bias and
the shortcut bias into ``b1``, the identity residual ``x`` taken in float32,
and the output rounded to ``x.dtype`` once.

Layouts: ``x``/``skip`` NHWC, ``w0``/``w1`` OIHW (PyTorch's conv layout; the
JAX functions take HWIO), ``shortcut_w`` (Cin, Cout) (the NIN's ``dense``
weight transposed; any strides, so the transposed view of the module's
(Cout, Cin) weight serves without a copy), ``gamma*``/``beta*``/``b*``/
``shortcut_b`` (C,), ``temb_proj`` (B, Cout).  The split variant's
``gamma0``, ``beta0``, ``w0`` and ``shortcut_w`` are over the concat width
Ca + Cb, as the unfused split block holds them.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import nvcc
from .conv3x3 import hwio, launch_plan
from .forward_only import forward_only
from .fused_tail import (
    DTYPES,
    EVAL_ONLY,
    _packed_weight,
    check_arg,
    check_input,
    conv3x3_nhwc,
    group_norm_stats,
    packed_operand,
)
from .nvcc import KernelLibrary

# id(w1) -> the packed conv1 operand [w1 ; shortcut_w]; see `pack_conv1`.
_PACKED_CONV1: dict = {}


def _act_conv(h: torch.Tensor, gamma, beta, num_groups: int, w: torch.Tensor) -> torch.Tensor:
    """conv3x3(silu(GN(h))) of float32 NHWC ``h``, GroupNorm's statistics in
    float32, the activation and ``w`` rounded to ``w.dtype`` and their
    products summed in float32."""
    mean, rstd = group_norm_stats(h, num_groups)
    scale = rstd * gamma.float()
    shift = beta.float() - mean * scale
    a = F.silu(h * scale[:, None, None, :] + shift[:, None, None, :]).to(w.dtype).float()
    return conv3x3_nhwc(a, w.float())


def resblock_fused_plain(
    x: torch.Tensor,
    *,
    gamma0, beta0, num_groups0: int,
    w0, b0, temb_proj,
    gamma1, beta1, num_groups1: int,
    w1, b1,
    shortcut_w=None, shortcut_b=None,
    skip_rescale: bool = False,
) -> torch.Tensor:
    """:func:`resblock_fused` in plain PyTorch, in the kernel's precision."""
    if shortcut_w is None and shortcut_b is not None:
        raise ValueError("shortcut_b needs shortcut_w")
    xf = x.float()
    bt = b0.float()[None, :]
    if temb_proj is not None:
        bt = bt + temb_proj.float()
    h = _act_conv(xf, gamma0, beta0, num_groups0, w0) + bt[:, None, None, :]
    bias1 = b1.float()
    if shortcut_b is not None:
        bias1 = bias1 + shortcut_b.float()
    h1 = _act_conv(h, gamma1, beta1, num_groups1, w1) + bias1
    res = xf if shortcut_w is None else xf.to(shortcut_w.dtype).float() @ shortcut_w.float()
    out = (res + h1) * (1.0 / math.sqrt(2.0) if skip_rescale else 1.0)
    return out.to(x.dtype)


def resblock_fused_split_plain(x: torch.Tensor, skip: torch.Tensor, **kwargs) -> torch.Tensor:
    """:func:`resblock_fused_split` in plain PyTorch: the block on the real
    concat, which is the same function."""
    return resblock_fused_plain(torch.cat([x, skip], dim=-1), **kwargs)


def pack_conv1(w1: torch.Tensor, shortcut_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """conv1's B operand: ``w1`` as (3, 3, Cout, Cout) flattened to
    (9 * Cout, Cout), with ``shortcut_w`` (Cin, Cout) stacked under it along
    K when given; contiguous."""
    w = hwio(w1).reshape(-1, w1.shape[0])
    return w if shortcut_w is None else torch.cat([w, shortcut_w], dim=0)


def _packed_conv1(w1: torch.Tensor, shortcut_w: Optional[torch.Tensor]) -> torch.Tensor:
    """:func:`pack_conv1`, once per weight: kept under ``w1`` while neither
    source changes (`ops.fused_tail.packed_operand`)."""
    sources = (w1,) if shortcut_w is None else (w1, shortcut_w)
    return packed_operand(_PACKED_CONV1, w1, sources, pack_conv1)


def block_plans(B: int, H: int, W: int, Ca: int, Cb: int, Cout: int, dtype: torch.dtype, mix: bool,
                inputs_aligned: bool = True):
    """The launch plans of conv0 (K = 9 * Cin) and of conv1 with the folded
    shortcut (K = 9 * Cout, + Cin for a channel mix), Cin = Ca + Cb.  The
    activations are scratch the wrapper aligns; the folded columns read x
    and skip, whose 16-byte copies also need both halves' widths to be whole
    vectors and (``inputs_aligned``) their addresses aligned."""
    M, Cin = B * H * W, Ca + Cb
    vec = 16 // (4 if dtype == torch.float32 else 2)
    fold_ok = not mix or (inputs_aligned and Ca % vec == 0 and Cb % vec == 0)
    return (
        launch_plan(M, Cin, Cout, dtype),
        launch_plan(M, Cout, Cout, dtype, x_aligned=fold_ok, extra=Cin if mix else 0),
    )


@functools.cache
def load_library() -> KernelLibrary:
    """Build ``csrc/resblock_fused.cu`` (once per source content) and load it."""
    built = nvcc.build("resblock_fused")
    p, i = ctypes.c_void_p, ctypes.c_int
    built.lib.resblock_fused_launch.argtypes = [
        p, p, i, i,            # x, skip, Ca, Cb
        p, p, i,               # gamma0, beta0, G0
        p, p, p,               # w0 packed, b0, temb
        p, p, i,               # gamma1, beta1, G1
        p, p, i, p,            # [w1 ; ws] packed, b1, mix, bs
        ctypes.c_float,        # res_scale
        p, p, p, p,            # out, scratch a0, h, a1
        i, i, i, i, i,         # B, H, W, Cout, dtype
        *[i] * 8, *[i] * 8,    # the plans of conv0 and conv1
        p,                     # stream
    ]
    built.lib.resblock_fused_launch.restype = ctypes.c_int
    built.lib.resblock_fused_error_string.argtypes = [ctypes.c_int]
    built.lib.resblock_fused_error_string.restype = ctypes.c_char_p
    return built


def _run(
    name: str, x: torch.Tensor, skip: Optional[torch.Tensor], *,
    gamma0, beta0, num_groups0, w0, b0, temb_proj,
    gamma1, beta1, num_groups1, w1, b1,
    shortcut_w, shortcut_b, skip_rescale,
) -> Optional[torch.Tensor]:
    """Check the arguments of either wrapper; on CUDA launch the kernel and
    return its output, on the CPU return None."""
    check_input(name, x)
    B, H, W, Ca = x.shape
    dev, dt = x.device, x.dtype
    check_arg("x", x, dev, dt, (B, H, W, Ca))
    Cb = 0
    if skip is not None:
        Cb = skip.shape[-1]
        check_arg("skip", skip, dev, dt, (B, H, W, Cb))
    Cin, Cout = Ca + Cb, w0.shape[0]
    if Cin % num_groups0 != 0 or Cout % num_groups1 != 0:
        raise ValueError(f"{Cin} or {Cout} channels do not split into {num_groups0} or {num_groups1} groups")
    f32 = torch.float32
    check_arg("gamma0", gamma0, dev, f32, (Cin,))
    check_arg("beta0", beta0, dev, f32, (Cin,))
    check_arg("w0", w0, dev, dt, (Cout, Cin, 3, 3))
    check_arg("b0", b0, dev, f32, (Cout,))
    if temb_proj is not None:
        check_arg("temb_proj", temb_proj, dev, f32, (B, Cout))
    check_arg("gamma1", gamma1, dev, f32, (Cout,))
    check_arg("beta1", beta1, dev, f32, (Cout,))
    check_arg("w1", w1, dev, dt, (Cout, Cout, 3, 3))
    check_arg("b1", b1, dev, f32, (Cout,))
    if shortcut_w is None:
        if Cin != Cout:
            raise ValueError(f"the identity residual needs Cin == Cout, got {Cin} and {Cout}")
        if shortcut_b is not None:
            raise ValueError("shortcut_b needs shortcut_w")
    else:
        check_arg("shortcut_w", shortcut_w, dev, dt, (Cin, Cout), contiguous=False)
        if shortcut_b is not None:
            check_arg("shortcut_b", shortcut_b, dev, f32, (Cout,))
    if dev.type == "cpu":
        return None

    lib = load_library().lib
    mix = shortcut_w is not None
    aligned = x.data_ptr() % 16 == 0 and (skip is None or skip.data_ptr() % 16 == 0)
    plan0, plan1 = block_plans(B, H, W, Ca, Cb, Cout, dt, mix, aligned)
    w0_kn, w1_kn = _packed_weight(w0), _packed_conv1(w1, shortcut_w)
    out = torch.empty((B, H, W, Cout), dtype=dt, device=dev)
    # a0 (T), h (float32), a1 (T): one allocation, each part 256-byte aligned
    M, item = B * H * W, x.element_size()
    sizes = [-(-n // 256) * 256 for n in (M * Cin * item, M * Cout * 4, M * Cout * item)]
    scratch = torch.empty(sum(sizes), dtype=torch.uint8, device=dev)
    a0, h, a1 = (scratch.data_ptr() + sum(sizes[:i]) for i in range(3))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = lib.resblock_fused_launch(
        x.data_ptr(), ptr(skip), Ca, Cb,
        gamma0.data_ptr(), beta0.data_ptr(), num_groups0,
        w0_kn.data_ptr(), b0.data_ptr(), ptr(temb_proj),
        gamma1.data_ptr(), beta1.data_ptr(), num_groups1,
        w1_kn.data_ptr(), b1.data_ptr(), int(mix), ptr(shortcut_b),
        1.0 / math.sqrt(2.0) if skip_rescale else 1.0,
        out.data_ptr(), a0, h, a1,
        B, H, W, Cout, DTYPES[dt], *plan0.c_args(), *plan1.c_args(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        msg = lib.resblock_fused_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")
    return out


def resblock_fused(
    x: torch.Tensor,
    *,
    gamma0, beta0, num_groups0: int,
    w0, b0, temb_proj,
    gamma1, beta1, num_groups1: int,
    w1, b1,
    shortcut_w=None, shortcut_b=None,
    skip_rescale: bool = False,
) -> torch.Tensor:
    """A whole eval resblock on NHWC ``x`` (see the module docstring).

    ``x``, ``w0``, ``w1``, ``shortcut_w`` float32 or bfloat16 (the same),
    the vectors and ``temb_proj`` float32, all contiguous; ``temb_proj``
    may be None, ``shortcut_w`` None means the identity residual.
    """
    kwargs = dict(
        gamma0=gamma0, beta0=beta0, num_groups0=num_groups0, w0=w0, b0=b0, temb_proj=temb_proj,
        gamma1=gamma1, beta1=beta1, num_groups1=num_groups1, w1=w1, b1=b1,
        shortcut_w=shortcut_w, shortcut_b=shortcut_b, skip_rescale=skip_rescale,
    )
    return forward_only(
        "resblock_fused", lambda: _call(resblock_fused, x, None, kwargs), [x, *kwargs.values()], EVAL_ONLY
    )


def resblock_fused_split(
    x: torch.Tensor,
    skip: torch.Tensor,
    *,
    gamma0, beta0, num_groups0: int,
    w0, b0, temb_proj,
    gamma1, beta1, num_groups1: int,
    w1, b1,
    shortcut_w=None, shortcut_b=None,
    skip_rescale: bool = False,
) -> torch.Tensor:
    """:func:`resblock_fused` on the virtual concat cat(x, skip), with the
    same arguments over the concat width; GroupNorm groups may straddle the
    boundary between x's and skip's channels."""
    kwargs = dict(
        gamma0=gamma0, beta0=beta0, num_groups0=num_groups0, w0=w0, b0=b0, temb_proj=temb_proj,
        gamma1=gamma1, beta1=beta1, num_groups1=num_groups1, w1=w1, b1=b1,
        shortcut_w=shortcut_w, shortcut_b=shortcut_b, skip_rescale=skip_rescale,
    )
    return forward_only(
        "resblock_fused_split", lambda: _call(resblock_fused_split, x, skip, kwargs),
        [x, skip, *kwargs.values()], EVAL_ONLY,
    )


def _call(wrapper, x, skip, kwargs):
    """The call as the wrapper makes it: the kernel on CUDA (counted), the
    plain version on the CPU."""
    out = _run(wrapper.__name__, x, skip, **kwargs)
    if out is not None:
        wrapper.launches += 1
        return out
    if skip is None:
        return resblock_fused_plain(x, **kwargs)
    return resblock_fused_split_plain(x, skip, **kwargs)


resblock_fused.launches = 0
resblock_fused_split.launches = 0
