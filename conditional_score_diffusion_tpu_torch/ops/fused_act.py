"""Fused bias + leaky ReLU with gain: ``scale * leaky_relu(x + bias,
negative_slope)``, the bias along the last axis.

Port of `conditional_score_diffusion_tpu/ops/fused_act.py:fused_leaky_relu`
(:16, the XLA op) and of its TPU kernel
`ops/pallas_kernels.py:fused_leaky_relu_pallas` (:188).  The CUDA kernel is
`csrc/fused_bias_act.cu` (its header says what bounds it on the card and
what its design does about that); `ops/nvcc.py` builds it for sm_90a into
`_build/` at first use, and it is called through ctypes.  No model of the
JAX package calls this op (its docstring, :1-8), so it is reached through
this entry alone.

:func:`fused_leaky_relu` (and :func:`fused_leaky_relu_kernel`, the name of
the TPU kernel's counterpart) checks its arguments, then takes the plain
version :func:`fused_leaky_relu_plain` for a CPU tensor and launches the
kernel for a CUDA tensor; there is no other path.
``fused_leaky_relu_kernel.launches`` counts the kernel's launches.

The gradient goes through `FusedLeakyReLUFunction`: the forward is the
kernel (or the plain version on the CPU), the backward plain PyTorch from
the saved output, ``dx = g * scale * where(out >= 0, 1, slope)`` and
``dbias = dx`` summed over every axis but the last (``scale > 0`` and
``negative_slope >= 0``, both checked, keep the sign of ``out`` that of
``x + bias``).  The JAX kernel has no VJP and
the XLA op gets one from autodiff, so no backward kernel is owed.

``x`` and ``bias`` are float32 or bfloat16 (the same dtype); the arithmetic
is float32 and the output is rounded to ``x.dtype`` once.  JAX computes a
bfloat16 ``x + bias`` in bfloat16 and rounds again after each product, so
the two differ by up to two bfloat16 steps there.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import nvcc
from .fused_tail import DTYPES
from .nvcc import KernelLibrary

NEGATIVE_SLOPE = 0.2
SCALE = 2**0.5


def fused_leaky_relu_plain(
    x: torch.Tensor, bias: Optional[torch.Tensor] = None, negative_slope: float = NEGATIVE_SLOPE,
    scale: float = SCALE,
) -> torch.Tensor:
    """The same function in plain PyTorch, float32 arithmetic, rounded to
    ``x.dtype`` once (the kernel's arithmetic, operation for operation)."""
    h = x.float()
    if bias is not None:
        h = h + bias.float()
    return (torch.where(h >= 0, h, h * negative_slope) * scale).to(x.dtype)


@functools.cache
def load_library() -> KernelLibrary:
    """Build ``csrc/fused_bias_act.cu`` (once per source content) and load it."""
    built = nvcc.build("fused_bias_act")
    built.lib.fused_bias_act_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    built.lib.fused_bias_act_launch.restype = ctypes.c_int
    built.lib.fused_bias_act_error_string.argtypes = [ctypes.c_int]
    built.lib.fused_bias_act_error_string.restype = ctypes.c_char_p
    return built


def _check(x: torch.Tensor, bias: Optional[torch.Tensor], negative_slope: float, scale: float) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_leaky_relu runs on cpu or cuda, not {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.ndim == 0 or x.numel() == 0:
        raise ValueError(f"x must have a last axis and elements, got shape {tuple(x.shape)}")
    if bias is not None:
        if bias.device != x.device or bias.dtype != x.dtype:
            raise TypeError(f"bias must be {x.dtype} on {x.device}, got {bias.dtype} on {bias.device}")
        if tuple(bias.shape) != (x.shape[-1],):
            raise ValueError(f"bias must have shape ({x.shape[-1]},), got {tuple(bias.shape)}")
    if not (scale > 0 and negative_slope >= 0):
        raise ValueError(
            "the backward reads the sign of x + bias from the output, so scale must be positive and"
            f" negative_slope not negative; got scale {scale}, negative_slope {negative_slope}"
        )


def _launch(x: torch.Tensor, bias: Optional[torch.Tensor], negative_slope: float, scale: float) -> torch.Tensor:
    x = x.contiguous()
    bias = None if bias is None else bias.contiguous()
    lib = load_library().lib
    out = torch.empty_like(x)
    err = lib.fused_bias_act_launch(
        x.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(), x.numel(), x.shape[-1],
        negative_slope, scale, DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        msg = lib.fused_bias_act_error_string(err).decode()
        raise RuntimeError(f"fused_bias_act launch failed: CUDA error {err} ({msg})")
    fused_leaky_relu_kernel.launches += 1
    return out


class FusedLeakyReLUFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias, negative_slope, scale):
        if x.device.type == "cpu":
            out = fused_leaky_relu_plain(x, bias, negative_slope, scale)
        else:
            out = _launch(x, bias, negative_slope, scale)
        ctx.save_for_backward(out)
        ctx.negative_slope, ctx.scale, ctx.has_bias = negative_slope, scale, bias is not None
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        # JAX's order: the gain first, then the slope where x + bias < 0; a
        # negative zero is what the slope made of a small negative input
        gs = g * ctx.scale
        dx = torch.where((out > 0) | ((out == 0) & ~torch.signbit(out)), gs, gs * ctx.negative_slope)
        dbias = None
        if ctx.has_bias and ctx.needs_input_grad[1]:
            dbias = dx.reshape(-1, dx.shape[-1]).sum(0)
        return dx, dbias, None, None


def fused_leaky_relu_kernel(
    x: torch.Tensor, bias: Optional[torch.Tensor] = None, negative_slope: float = NEGATIVE_SLOPE,
    scale: float = SCALE,
) -> torch.Tensor:
    """``scale * leaky_relu(x + bias, negative_slope)``: the kernel for a
    CUDA tensor, the plain version for a CPU tensor, after the same checks
    on both; differentiable in ``x`` and ``bias``."""
    _check(x, bias, negative_slope, scale)
    return FusedLeakyReLUFunction.apply(x, bias, float(negative_slope), float(scale))


fused_leaky_relu_kernel.launches = 0


def fused_leaky_relu(
    x: torch.Tensor, bias: Optional[torch.Tensor] = None, negative_slope: float = NEGATIVE_SLOPE,
    scale: float = SCALE,
) -> torch.Tensor:
    """The op entry (JAX `ops/fused_act.py:fused_leaky_relu`); it runs
    :func:`fused_leaky_relu_kernel`."""
    return fused_leaky_relu_kernel(x, bias, negative_slope, scale)
