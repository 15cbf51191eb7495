"""Fused GroupNorm -> SiLU -> 3x3 conv (+ bias, + temb): the resblock tail.

Port of `conditional_score_diffusion_tpu/ops/fused_block_pallas.py`:
`group_norm_stats` (:44) and `gn_silu_conv3x3_nhwc` (:593), whose Pallas
kernel is `gn_silu_conv3x3_hmajor` (:107).  The CUDA kernel is
`csrc/gn_silu_conv3x3.cu` (its header says what bounds it on the card and
what its design does about that): a GroupNorm pass that writes the
activation silu(GroupNorm(x)), rounded to x's type, once per element, then
the 3x3 main loop that it shares with kernel 4 (`csrc/conv3x3_core.cuh`,
launched with the plan of `ops.conv3x3.launch_plan`) on that activation.
`ops/nvcc.py` builds it for sm_90a into `_build/` at first use; it is
called through ctypes.

:func:`gn_silu_conv3x3` takes the kernel for a CUDA tensor and the plain
version :func:`gn_silu_conv3x3_plain` for a CPU tensor, after the same
checks of its arguments on both; there is no other path.
``gn_silu_conv3x3.launches`` counts the kernel's launches.  The kernel has
no backward (eval only, as in JAX): where a gradient could flow, the call
goes through `ops.forward_only`, whose backward raises.

Layouts: ``x`` NHWC, ``w`` OIHW (PyTorch's conv layout; the JAX function
takes HWIO), ``gamma``/``beta`` (Cin,), ``bias`` (Cout,), ``temb`` (B, Cout).
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Optional

import torch
import torch.nn.functional as F

from . import nvcc
from .forward_only import forward_only
from .nvcc import KernelLibrary

GN_EPS = 1e-6  # GroupNorm epsilon of the DDPM resblock
DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernels' dtype codes
# Why the eval kernels (this tail, `ops/fused_block.py`) have no backward.
EVAL_ONLY = (
    "an eval-mode kernel, as in JAX, whose call sites are gated on eval mode; "
    "no ROADMAP.md item trains through it (train-mode blocks run unfused)"
)


def group_norm_stats(x: torch.Tensor, num_groups: int, eps: float = GN_EPS):
    """Per-(batch, channel) GroupNorm ``(mean, rstd)`` of NHWC ``x`` (or
    NDHWC: any spatial axes between the first and the last), float32, each
    of shape (B, C)."""
    B, C = x.shape[0], x.shape[-1]
    xg = x.float().reshape(B, -1, num_groups, C // num_groups)
    var, mean = torch.var_mean(xg, dim=(1, 3), unbiased=False)
    rstd = torch.rsqrt(var + eps)
    return (
        mean.repeat_interleave(C // num_groups, dim=1),
        rstd.repeat_interleave(C // num_groups, dim=1),
    )


def conv3x3_nhwc(x: torch.Tensor, w: torch.Tensor, bias=None, stride: int = 1, padding: int = 1):
    """3x3 conv of NHWC ``x`` with OIHW ``w``; NHWC out."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, bias, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def gn_silu_conv3x3_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int,
    bias: Optional[torch.Tensor] = None,
    temb: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The same function in plain PyTorch: float32 GroupNorm and SiLU, the
    activation and ``w`` rounded to ``x.dtype``, their products summed in
    float32 (``F.conv2d``, padding 1), then bias and temb added in float32;
    out in ``x.dtype``, rounded once, as the kernel does."""
    mean, rstd = group_norm_stats(x, num_groups)
    scale = rstd * gamma.float()
    shift = beta.float() - mean * scale
    h = x.float() * scale[:, None, None, :] + shift[:, None, None, :]
    h = F.silu(h).to(x.dtype).float()
    y = conv3x3_nhwc(h, w.to(x.dtype).float())
    if bias is not None:
        y = y + bias.float()
    if temb is not None:
        y = y + temb.float()[:, None, None, :]
    return y.to(x.dtype)


@functools.cache
def load_library() -> KernelLibrary:
    """Build ``csrc/gn_silu_conv3x3.cu`` (once per source content) and load it."""
    built = nvcc.build("gn_silu_conv3x3")
    built.lib.gn_silu_conv3x3_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 15 + [
        ctypes.c_void_p
    ]
    built.lib.gn_silu_conv3x3_launch.restype = ctypes.c_int
    built.lib.gn_silu_conv3x3_error_string.argtypes = [ctypes.c_int]
    built.lib.gn_silu_conv3x3_error_string.restype = ctypes.c_char_p
    return built


def check_arg(name, t, device, dtype, shape, contiguous=True):
    """Raise unless ``t`` is on ``device``, of ``dtype`` and ``shape``, and
    (``contiguous``) contiguous: what a kernel of the port takes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_input(fn_name: str, x: torch.Tensor) -> None:
    """The device, dtype and rank every kernel wrapper asks of its NHWC input."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn_name} runs on cpu or cuda, not {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")


def gn_silu_conv3x3(
    x: torch.Tensor,
    w: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int,
    bias: Optional[torch.Tensor] = None,
    temb: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``conv3x3(silu(GroupNorm(x))) (+ bias) (+ temb)``, NHWC.

    Takes ``x`` and ``w`` float32 or bfloat16 (the same), ``gamma``,
    ``beta``, ``bias``, ``temb`` float32, all contiguous, and raises on
    anything else, on either device.  CPU tensors then take
    :func:`gn_silu_conv3x3_plain`; CUDA tensors launch the kernel.
    """
    check_input("gn_silu_conv3x3", x)
    B, H, W, Cin = x.shape
    Cout = w.shape[0]
    if Cin % num_groups != 0:
        raise ValueError(f"{Cin} channels do not split into {num_groups} groups")
    dev = x.device
    check_arg("x", x, dev, x.dtype, (B, H, W, Cin))
    check_arg("w", w, dev, x.dtype, (Cout, Cin, 3, 3))
    check_arg("gamma", gamma, dev, torch.float32, (Cin,))
    check_arg("beta", beta, dev, torch.float32, (Cin,))
    if bias is not None:
        check_arg("bias", bias, dev, torch.float32, (Cout,))
    if temb is not None:
        check_arg("temb", temb, dev, torch.float32, (B, Cout))
    args = (x, w, gamma, beta, num_groups, bias, temb)
    if dev.type == "cpu":
        return forward_only("gn_silu_conv3x3", lambda: gn_silu_conv3x3_plain(*args), args, EVAL_ONLY)
    return forward_only("gn_silu_conv3x3", lambda: _launch(*args), args, EVAL_ONLY)


# id(w) -> (a weak reference to w, the sources' keys, w as the main loop's
# B operand); see `_packed_weight`.
_PACKED: dict = {}


def _weight_key(w: torch.Tensor):
    """What a packed copy of ``w`` was made from: its storage, version
    counter, dtype, device, shape and strides.  `nn.Module.to` and its kin
    swap a parameter's data in place (same object, same version), which
    this sees; a view shares its base's version counter."""
    return (w.data_ptr(), w._version, w.dtype, w.device, tuple(w.shape), w.stride())


def packed_operand(cache: dict, anchor: torch.Tensor, sources, make):
    """``make(*sources)``, kept in ``cache`` under ``id(anchor)`` while
    ``anchor`` lives and every source's :func:`_weight_key` stands still;
    the entry goes with ``anchor``.  For an eval kernel's B operand made
    from the model's own weights, which no call changes: the repack (a copy
    kernel of 0.7-3 MB a call) is made once per weight.  An in-place update
    of a source bumps its version and a conversion (``.to``, ``.cuda``,
    ``.bfloat16``) moves its data, and either repacks; an in-place write
    through ``.data`` does neither, and the port makes none."""
    key = id(anchor)
    stamp = tuple(_weight_key(t) for t in sources)
    hit = cache.get(key)
    if hit is not None and hit[0]() is anchor and hit[1] == stamp:
        return hit[2]
    packed = make(*sources)
    cache[key] = (weakref.ref(anchor, lambda _, key=key: cache.pop(key, None)), stamp, packed)
    return packed


def _packed_weight(w: torch.Tensor) -> torch.Tensor:
    """``w`` repacked to (3, 3, Cin, Cout) (`ops.conv3x3.hwio`), once per
    weight (:func:`packed_operand`)."""
    from .conv3x3 import hwio  # conv3x3 imports this module

    return packed_operand(_PACKED, w, (w,), hwio)


def _launch(x, w, gamma, beta, num_groups, bias, temb):
    from .conv3x3 import launch_plan  # conv3x3 imports this module

    B, H, W, Cin = x.shape
    Cout, dev = w.shape[0], x.device
    lib = load_library().lib
    out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=dev)
    act = torch.empty_like(x)  # silu(GroupNorm(x)), the main loop's A operand
    plan = launch_plan(B * H * W, Cin, Cout, x.dtype, x_aligned=act.data_ptr() % 16 == 0)
    w_kn = _packed_weight(w)
    err = lib.gn_silu_conv3x3_launch(
        x.data_ptr(), w_kn.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if temb is None else temb.data_ptr(),
        out.data_ptr(), act.data_ptr(),
        B, H, W, Cin, Cout, num_groups, DTYPES[x.dtype], *plan.c_args(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        msg = lib.gn_silu_conv3x3_error_string(err).decode()
        raise RuntimeError(f"gn_silu_conv3x3 launch failed: CUDA error {err} ({msg})")
    gn_silu_conv3x3.launches += 1
    return out


gn_silu_conv3x3.launches = 0
