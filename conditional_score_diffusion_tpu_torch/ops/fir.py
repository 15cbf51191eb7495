"""The separable 4-tap FIR resampling of NCSN++ at factor 2: upsample and
downsample, NHWC.

Port of `conditional_score_diffusion_tpu/ops/pallas_kernels.py`:
`fir_upsample2` (:131, Pallas kernel `_up_kernel`) and `fir_downsample2`
(:156, `_down_kernel`), which compute exactly `upsample_2d(x, k, 2)` and
`downsample_2d(x, k, 2)` of `ops/upfirdn.py` with a 4-tap 1-D kernel.  Both
CUDA kernels are in `csrc/fir_resample.cu` (its header says what bounds them
on the card and what the design does about that); `ops/nvcc.py` builds it
for sm_90a into `_build/` at first use, and it is called through ctypes.

:func:`fir_upsample2` and :func:`fir_downsample2` check their arguments,
then take the plain version (:func:`fir_upsample2_plain`,
:func:`fir_downsample2_plain`: `ops/upfirdn.py` at factor 2) for a CPU
tensor and launch the kernel for a CUDA tensor; there is no other path.
``.launches`` on each wrapper counts its kernel's launches.  The kernels
have no backward: `ops/upfirdn.py` sends a call through which a gradient
must flow to the plain version instead, and a direct call here that
carries one goes through `ops.forward_only`, whose backward raises
(:data:`NO_BACKWARD`).

With the per-axis taps ``c = k / sum(k) * gain`` (gain 2 for up, 1 for
down) and zeros outside the image, in polyphase form::

    up:   out[2t] = c3*x[t-1] + c1*x[t]      out[2t+1] = c2*x[t] + c0*x[t+1]
    down: out[t]  = c3*x[2t-1] + c2*x[2t] + c1*x[2t+1] + c0*x[2t+2]

on both spatial axes; ``x`` float32 or bfloat16, sums in float32, the output
rounded to ``x.dtype`` once.

:func:`launch_plan` is a launch's plan (vector width, the run of pixels a
thread walks, block size, block count), computed on the host so the CPU
tests reach it; the C entries refuse a plan they did not compile or that
does not fit the call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import nvcc
from .forward_only import forward_only
from .fused_tail import DTYPES, check_arg, check_input
from .nvcc import KernelLibrary
from .upfirdn import downsample_2d_plain, upsample_2d_plain

FIR_KERNEL = (1.0, 3.0, 3.0, 1.0)  # every recipe's fir_kernel
NO_BACKWARD = (
    "a call that carries a gradient takes the plain version (ops/upfirdn.py); a FIR gradient kernel"
    " is an open question (ROADMAP.md section 3, FIR gradient)"
)

INT32_LIMIT = 2**31  # offsets within one image and the thread count are 32-bit
VEC_BYTES = (16, 8, 4)  # the vector accesses, widest first; below them one element a thread
SECTOR = 32  # bytes of one memory sector
# A thread walks RUN pixels along W where a pixel's channels are whole
# sectors and that leaves MIN_RUN_THREADS threads or more (~750 an SM),
# else 1.  Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section
# 6): a run of 2 beat 1 by 8-15% at the 8x80x80x64 upsample and the
# 8x160x160x64 and 8x80x80x64 downsamples in float32 (bfloat16: within
# 3%), and lost by up to 50% where it left fewer threads; runs of 4 and 8
# were slower per forward.
RUN = 2
MIN_RUN_THREADS = 98_304
THREADS = 128  # a block; 64 and 256 were no faster


class FirPlan(NamedTuple):
    """One launch of a FIR kernel; see :func:`launch_plan`."""

    vec: int  # channels a thread moves in one access (vec * itemsize bytes)
    run: int  # pixels along W a thread walks: input pixels (up), output pixels (down)
    threads: int  # threads a block
    blocks: int


def launch_plan(
    B: int, H: int, W: int, C: int, dtype: torch.dtype, ptrs: Sequence[int], down: bool = False
) -> FirPlan:
    """The plan of one upsample (or, ``down``, downsample) of a (B, H, W, C)
    input of ``dtype`` whose input and output addresses are ``ptrs``.

    The vector is the widest of :data:`VEC_BYTES` that divides a pixel's
    ``C * itemsize`` bytes and every address (an offset view of a tensor
    need not be aligned), else one element.  One thread per (row, run of
    pixels, vector); the run is :data:`RUN` or 1 (see there).
    """
    item = torch.tensor([], dtype=dtype).element_size()
    vec_bytes = next((v for v in VEC_BYTES if (C * item) % v == 0 and all(p % v == 0 for p in ptrs)), item)
    vec = vec_bytes // item
    rows, steps = (B * H // 2, W // 2) if down else (B * H, W)
    if H * W * C * (1 if down else 4) >= INT32_LIMIT or rows * steps * (C // vec) >= INT32_LIMIT:
        raise ValueError(f"FIR call {B}x{H}x{W}x{C} is past the kernels' 32-bit offsets")
    threads = lambda run: rows * -(-steps // run) * (C // vec)  # noqa: E731
    whole_sectors = (C * item) % SECTOR == 0
    run = RUN if whole_sectors and threads(RUN) >= MIN_RUN_THREADS else 1
    return FirPlan(vec, run, THREADS, -(-threads(run) // THREADS))


def norm_taps(k: Sequence[float], gain: float) -> np.ndarray:
    """The 4 per-axis taps ``k / sum(k) * gain``, float32."""
    k = np.asarray(k, dtype=np.float32)
    if k.shape != (4,):
        raise ValueError(f"the factor-2 FIR kernels take a 4-tap 1-D kernel, got shape {k.shape}")
    return k / k.sum() * gain


def fir_upsample2_plain(x: torch.Tensor, k: Sequence[float] = FIR_KERNEL) -> torch.Tensor:
    """`upsample_2d(x, k, factor=2)` in plain PyTorch."""
    return upsample_2d_plain(x, k, factor=2)


def fir_downsample2_plain(x: torch.Tensor, k: Sequence[float] = FIR_KERNEL) -> torch.Tensor:
    """`downsample_2d(x, k, factor=2)` in plain PyTorch."""
    return downsample_2d_plain(x, k, factor=2)


@functools.cache
def load_library() -> KernelLibrary:
    """Build ``csrc/fir_resample.cu`` (once per source content) and load it."""
    built = nvcc.build("fir_resample")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn in (built.lib.fir_upsample2_launch, built.lib.fir_downsample2_launch):
        # x, out, B, H, W, C, c0..c3, dtype, the plan's vec, run, threads, blocks, stream
        fn.argtypes = [p, p, i, i, i, i, f, f, f, f, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    built.lib.fir_resample_error_string.argtypes = [ctypes.c_int]
    built.lib.fir_resample_error_string.restype = ctypes.c_char_p
    return built


def _launch(name: str, x: torch.Tensor, out_hw, taps: np.ndarray) -> torch.Tensor:
    B, H, W, C = x.shape
    lib = load_library().lib
    out = torch.empty((B, *out_hw, C), dtype=x.dtype, device=x.device)
    plan = launch_plan(B, H, W, C, x.dtype, (x.data_ptr(), out.data_ptr()), down=name == "fir_downsample2")
    err = getattr(lib, f"{name}_launch")(
        x.data_ptr(), out.data_ptr(), B, H, W, C, *(float(c) for c in taps), DTYPES[x.dtype], *plan,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        msg = lib.fir_resample_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")
    return out


def fir_upsample2(x: torch.Tensor, k: Sequence[float] = FIR_KERNEL) -> torch.Tensor:
    """`upsample_2d(x, k, factor=2)` of NHWC ``x`` (float32 or bfloat16,
    contiguous, any channel count): (B, H, W, C) -> (B, 2H, 2W, C)."""
    check_input("fir_upsample2", x)
    check_arg("x", x, x.device, x.dtype, x.shape)
    taps = norm_taps(k, gain=2.0)  # sqrt of the 2-D gain 4, per axis
    if x.device.type == "cpu":
        return forward_only("fir_upsample2", lambda: fir_upsample2_plain(x, k), (x,), NO_BACKWARD)

    def run():
        _, H, W, _ = x.shape
        out = _launch("fir_upsample2", x, (2 * H, 2 * W), taps)
        fir_upsample2.launches += 1
        return out

    return forward_only("fir_upsample2", run, (x,), NO_BACKWARD)


def fir_downsample2(x: torch.Tensor, k: Sequence[float] = FIR_KERNEL) -> torch.Tensor:
    """`downsample_2d(x, k, factor=2)` of NHWC ``x`` (float32 or bfloat16,
    contiguous, any channel count, even H and W): (B, H, W, C) ->
    (B, H/2, W/2, C)."""
    check_input("fir_downsample2", x)
    check_arg("x", x, x.device, x.dtype, x.shape)
    taps = norm_taps(k, gain=1.0)
    _, H, W, _ = x.shape
    if H % 2 or W % 2:
        raise ValueError(f"fir_downsample2 needs even H and W, got {H}x{W}")
    if x.device.type == "cpu":
        return forward_only("fir_downsample2", lambda: fir_downsample2_plain(x, k), (x,), NO_BACKWARD)

    def run():
        out = _launch("fir_downsample2", x, (H // 2, W // 2), taps)
        fir_downsample2.launches += 1
        return out

    return forward_only("fir_downsample2", run, (x,), NO_BACKWARD)


fir_upsample2.launches = 0
fir_downsample2.launches = 0
