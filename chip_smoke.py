#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what it computes.

    python3 chip_smoke.py

Phases, each printing its own line with its seconds:

1. device: needs a CUDA device (exits non-zero without one); prints the card's
   name and power limit as nvidia-smi gives them, and the TF32 switches
   (both off: the port runs float32 as float32).
2. build: builds the three kernel sources (csrc/gn_silu_conv3x3.cu,
   csrc/resblock_fused.cu, csrc/fir_resample.cu) with nvcc, in parallel,
   each with its seconds and its ptxas lines.
3. kernel: each kernel against its plain PyTorch version at the shapes its
   path gives it (B=8), float32 and bfloat16 (2e-2 of the largest magnitude;
   float32 1e-4, the FIR kernels 1e-5): the fused tail at the flagship's
   20x20x192, 10x10x288, 5x5x288, with and without temb; the whole-resblock
   kernels at the flagship's six sites (block 10x10 192->288 with the NIN
   shortcut, 10x10 288->288, 5x5 288->288; split 5x5 288+288, 10x10
   288+288, 10x10 288+192 -> 288, where a 15-channel group straddles the
   concat), with and without temb and once with skip_rescale; then each
   one's time, its plain version's, a library yardstick's and its bound, by
   CUDA events.  The same three kernels at the NCSN++ block variant's sites
   (tails at 20x20x128 to 5x5x256; blocks with the 1x1-conv shortcut and
   skip_rescale, splits 256+256 and 256+128), checked only.  The FIR
   upsample and downsample at the 20 shapes of one NCSN++ forward (5x5 to
   160x160, 6 to 256 channels; a non-symmetric kernel at two of them),
   timed beside their plain versions, the depthwise cuDNN call and the
   bound.
4. agreement: the same weights with the kernels on and off: the float32
   tail path and the flagship block path (fused_block and fused_tail) in
   float32 and in bfloat16 compute; the NCSN++ path with the FIR kernels
   against their plain versions, and its block variant (fused_tail,
   fused_block) against the path without them, both float32.  Each: the
   score on the sampler's own input at t = 0.5, a 3-step sample and the raw
   network output on the clean batch; float32 at 1e-4, bfloat16 as
   `agreement` says (2e-2).
5. main (the flagship block path): texture160 test batch 0 (8 images, y =
   8x SR degradation), the full-width ddpm_paired with seeded N(0, 0.02)
   weights, bfloat16 compute through `get_score_fn(compute_dtype=...)` ->
   `get_conditional_score_fn` -> `get_pc_conditional_sampler` (as the JAX
   bench composes it), fused_block and fused_tail on, 1000 steps.  Each
   kernel's launch counter, set to 0 just before, must read exactly its
   count per forward x 2 x 1000 just after.
6. main (the float32 tail path): the same batch and weights, float32,
   fused_tail only, through `get_conditional_sampling_fn`, 200 steps; the
   tail's counter must read 17 x 2 x 200.
7. main (the NCSN++ path, new): the DF2K direct 4x recipe on texture160
   (`texture160_kxsr_ncsnpp`): the first 8 test pairs (the recipe's eval
   batch of 32 cut to 8), x 160x160 and y the committed 40x40 LQ images;
   the full-width ncsnpp_KxSR (nf=64, ch_mult (1,1,2,2,4,4), 32.1 M
   parameters) with seeded N(0, 0.02) weights; the multi-speed VE SDE with
   sigma_y as the VS-CMDE schedule leaves it (sigma_y,max 138.6); float32
   through `get_conditional_sampling_fn`, 1000 steps; the FIR counters must
   read 15 x 2 x 1000 each.
8. result: a JSON line of the kernels, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from conditional_score_diffusion_tpu_torch.configs import (  # noqa: E402
    texture160_kxsr_ncsnpp_block_config,
    texture160_kxsr_ncsnpp_config,
    texture160_sr_cmde_bf16_block_config,
    texture160_sr_cmde_config,
)
from conditional_score_diffusion_tpu_torch.data.pkl_datasets import iter_test_batches  # noqa: E402
from conditional_score_diffusion_tpu_torch.models import create_model, init_model_random  # noqa: E402
from conditional_score_diffusion_tpu_torch.models.wrappers import (  # noqa: E402
    get_conditional_score_fn,
    get_model_fn,
    get_score_fn,
)
from conditional_score_diffusion_tpu_torch.ops import fir, fused_block, fused_tail  # noqa: E402
from conditional_score_diffusion_tpu_torch.ops.fused_tail import conv3x3_nhwc  # noqa: E402
from conditional_score_diffusion_tpu_torch.ops.upfirdn import setup_kernel  # noqa: E402
from conditional_score_diffusion_tpu_torch.profile_sampler import plain_versions, sampler_sde  # noqa: E402
from conditional_score_diffusion_tpu_torch.sampling import (  # noqa: E402
    get_conditional_sampling_fn,
    get_pc_conditional_sampler,
)
from conditional_score_diffusion_tpu_torch.sde import batch_mul  # noqa: E402

# Published dense peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet).
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # float32 outside the tensor cores
PEAK_BYTES = 3.35e12
BATCH, GROUPS = 8, 32
# Gated tails of one flagship forward: (H, C, calls per forward) with the
# tail alone (the float32 tail path) and with the whole-block kernels on.
TAIL_SHAPES = [(20, 192, 5, 5), (10, 288, 5, 0), (5, 288, 7, 0)]
# Whole-block sites of one flagship forward: (kernel, H, Ca, Cb, Cout, calls).
BLOCK_SHAPES = [
    ("resblock_fused", 10, 192, 0, 288, 1),  # down_4_0, NIN shortcut
    ("resblock_fused", 10, 288, 0, 288, 1),  # down_4_1
    ("resblock_fused", 5, 288, 0, 288, 4),  # down_5_0, down_5_1, mid_block0, mid_block1
    ("resblock_fused_split", 5, 288, 288, 288, 3),  # up_5_0 .. up_5_2
    ("resblock_fused_split", 10, 288, 288, 288, 2),  # up_4_0, up_4_1
    ("resblock_fused_split", 10, 288, 192, 288, 1),  # up_4_2: a group straddles channel 288
]
# Launches per forward on each path, counted from `DDPM._down_plan` /
# `_up_plan` (tests/test_torch_fused_block_model.py counts them again on the
# meta device): with the tail alone it fires on the 17 blocks at 20x20 and
# below; with the block kernels on, the 12 blocks at 10x10 and below take
# those, and the tail keeps the 5 at 20x20.
PER_FORWARD_TAIL_PATH = {"gn_silu_conv3x3": 17}
PER_FORWARD_BLOCK_PATH = {"resblock_fused": 6, "resblock_fused_split": 6, "gn_silu_conv3x3": 5}
# Kernels 1-3 at the sites of the NCSN++ recipe with fused_tail and
# fused_block on (texture160_kxsr_ncsnpp_block; 32 groups everywhere):
# the tails (H, C), and the blocks with their 1x1-conv shortcut and
# skip_rescale (kernel, H, Ca, Cb, Cout).  Checked, not timed: that variant
# is held by `agreement`, the NCSN++ main path runs the FIR kernels alone.
NCSNPP_TAIL_SHAPES = [(20, 128), (10, 128), (5, 256), (10, 256), (20, 256)]
NCSNPP_BLOCK_SHAPES = [
    ("resblock_fused", 10, 128, 0, 256),  # down_4_0, 1x1-conv shortcut
    ("resblock_fused", 10, 256, 0, 256),  # down_4_1
    ("resblock_fused", 5, 256, 0, 256),  # down_5_*, mid_block*
    ("resblock_fused_split", 5, 256, 256, 256),  # up_5_*
    ("resblock_fused_split", 10, 256, 256, 256),  # up_4_0, up_4_1
    ("resblock_fused_split", 10, 256, 128, 256),  # up_4_2: a 12-channel group straddles channel 256
]
# FIR calls of one NCSN++ forward, B=8: (kernel, H, C, calls).  Down: each
# BigGAN down block resamples h and x, the input pyramid its 6 channels;
# up: the same in the BigGAN up blocks and the output pyramid.
FIR_SHAPES = [
    ("fir_downsample2", 160, 64, 2), ("fir_downsample2", 80, 64, 2), ("fir_downsample2", 40, 128, 2),
    ("fir_downsample2", 20, 128, 2), ("fir_downsample2", 10, 256, 2),
    ("fir_downsample2", 160, 6, 1), ("fir_downsample2", 80, 6, 1), ("fir_downsample2", 40, 6, 1),
    ("fir_downsample2", 20, 6, 1), ("fir_downsample2", 10, 6, 1),
    ("fir_upsample2", 5, 256, 2), ("fir_upsample2", 10, 256, 2), ("fir_upsample2", 20, 128, 2),
    ("fir_upsample2", 40, 128, 2), ("fir_upsample2", 80, 64, 2),
    ("fir_upsample2", 5, 6, 1), ("fir_upsample2", 10, 6, 1), ("fir_upsample2", 20, 6, 1),
    ("fir_upsample2", 40, 6, 1), ("fir_upsample2", 80, 6, 1),
]
FIR_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
ASYMMETRIC_FIR = (1.0, 2.0, 5.0, 0.5)  # a non-symmetric 4-tap kernel, checked at one shape each
PER_FORWARD_NCSNPP_PATH = {"fir_upsample2": 15, "fir_downsample2": 15}
STEPS = 1000  # the new path: the flagship's full step count
TAIL_PATH_STEPS = 200  # the float32 tail path, cut from 1000 to keep the run short
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Kernels on against off, bfloat16 compute (see `agreement`).
BF16_AGREE_TOL = 2e-2

WRAPPERS = {
    "gn_silu_conv3x3": fused_tail.gn_silu_conv3x3,
    "resblock_fused": fused_block.resblock_fused,
    "resblock_fused_split": fused_block.resblock_fused_split,
    "fir_upsample2": fir.fir_upsample2,
    "fir_downsample2": fir.fir_downsample2,
}


def phase(name, t0, msg=""):
    print(f"[{name}] {time.perf_counter() - t0:.3f} s {msg}".rstrip(), flush=True)


def time_ms(fn, iters=100, warmup=10):
    """Mean device time of one call, by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def dname(dtype):
    return str(dtype).replace("torch.", "")


def itemsize(dtype):
    return torch.tensor([], dtype=dtype).element_size()


def bound(flops, nbytes, dtype):
    """Least time in ms: operations over the type's peak rate, or bytes over
    the memory rate, whichever is larger."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_close(label, got, want, dtype, tol=REL_TOL):
    """Raise unless ``got`` is ``want`` within ``tol[dtype]`` of the largest
    magnitude of ``want``; returns the largest difference."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != dtype:
        raise RuntimeError(f"{label}: kernel output {got.shape} {got.dtype}, want {want.shape} {dtype}")
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    ok = err <= tol[dtype] * scale
    print(
        f"  {label}: max_abs_err {err:.3e} rel {err / scale:.3e} tol rel {tol[dtype]:.0e}"
        f" {'ok' if ok else 'FAIL'}",
        flush=True,
    )
    if not ok:
        raise RuntimeError(f"{label}: kernel disagrees with its plain version")
    return err


# ---- the fused tail -------------------------------------------------------


def tail_inputs(h, c, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(BATCH, h, h, c, generator=g, device="cuda") * 1.5 + 0.3).to(dtype)
    w = (torch.randn(c, c, 3, 3, generator=g, device="cuda") / (9 * c) ** 0.5).to(dtype)
    gamma = 1.0 + 0.1 * torch.randn(c, generator=g, device="cuda")
    beta = 0.1 * torch.randn(c, generator=g, device="cuda")
    bias = 0.1 * torch.randn(c, generator=g, device="cuda")
    temb = torch.randn(BATCH, c, generator=g, device="cuda")
    return x, w, gamma, beta, bias, temb


def check_tail():
    """The tail kernel against plain at its shapes; returns per-shape rows."""
    rows = []
    for h, c, calls_tail_path, calls_block_path in TAIL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for with_temb in (False, True):
                x, w, gamma, beta, bias, temb = tail_inputs(h, c, dtype, seed=h * c)
                temb = temb if with_temb else None
                got = fused_tail.gn_silu_conv3x3(x, w, gamma, beta, GROUPS, bias=bias, temb=temb)
                want = fused_tail.gn_silu_conv3x3_plain(x, w, gamma, beta, GROUPS, bias=bias, temb=temb)
                err = check_close(f"tail {h}x{h}x{c} {dname(dtype)} temb={with_temb}", got, want, dtype)
                if with_temb:
                    continue
                flops = 2 * 9 * BATCH * h * h * c * c
                nbytes = itemsize(dtype) * (2 * BATCH * h * h * c + 9 * c * c) + 4 * 3 * c
                bound_ms, bound_by = bound(flops, nbytes, dtype)
                row = dict(
                    shape=f"{BATCH}x{h}x{h}x{c}", dtype=dname(dtype),
                    calls_per_forward_tail_path=calls_tail_path,
                    calls_per_forward_block_path=calls_block_path,
                    max_abs_err=err, gflop=flops / 1e9, bound_ms=bound_ms, bound_by=bound_by,
                    ms=time_ms(lambda: fused_tail.gn_silu_conv3x3(x, w, gamma, beta, GROUPS, bias=bias)),
                    plain_ms=time_ms(lambda: fused_tail.gn_silu_conv3x3_plain(x, w, gamma, beta, GROUPS, bias=bias)),
                    # no single PyTorch call computes GN+SiLU+conv: cuDNN's conv alone
                    library_ms=time_ms(lambda: conv3x3_nhwc(x, w, bias.to(dtype))),
                )
                print(
                    f"    time: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms,"
                    f" cuDNN conv only {row['library_ms']:.4f} ms,"
                    f" bound {bound_ms:.4f} ms ({bound_by}), {flops / row['ms'] / 1e9:.2f} TFLOP/s",
                    flush=True,
                )
                rows.append(row)
    return rows


# ---- the whole-resblock kernels ------------------------------------------


def block_inputs(h, ca, cb, cout, dtype, seed, with_temb=True):
    """Seeded inputs of one block call, as the model hands them over."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    cin = ca + cb
    x = (r(BATCH, h, h, ca) * 1.5 + 0.3).to(dtype)
    skip = (r(BATCH, h, h, cb) - 0.5).to(dtype) if cb else None
    kw = dict(
        gamma0=1.0 + 0.1 * r(cin), beta0=0.1 * r(cin), num_groups0=GROUPS,
        w0=(r(cout, cin, 3, 3) / math.sqrt(9 * cin)).to(dtype), b0=0.1 * r(cout),
        temb_proj=r(BATCH, cout) if with_temb else None,
        gamma1=1.0 + 0.1 * r(cout), beta1=0.1 * r(cout), num_groups1=GROUPS,
        w1=(r(cout, cout, 3, 3) / math.sqrt(9 * cout)).to(dtype), b1=0.1 * r(cout),
        shortcut_w=(r(cin, cout) / math.sqrt(cin)).to(dtype) if cin != cout else None,
        shortcut_b=0.1 * r(cout) if cin != cout else None,
    )
    return x, skip, kw


def block_call(x, skip, kw, plain=False):
    if skip is None:
        fn = fused_block.resblock_fused_plain if plain else fused_block.resblock_fused
        return fn(x, **kw)
    fn = fused_block.resblock_fused_split_plain if plain else fused_block.resblock_fused_split
    return fn(x, skip, **kw)


def block_work(h, ca, cb, cout, dtype):
    """Operations and bytes of one call: two 3x3 convs and, with a NIN
    shortcut, its product; x (and skip), the weights and the float32
    vectors and temb read once, out written once."""
    cin, px = ca + cb, BATCH * h * h
    mix = cin != cout
    flops = 2 * 9 * px * (cin + cout) * cout + (2 * px * cin * cout if mix else 0)
    nbytes = itemsize(dtype) * (px * cin + 9 * cout * (cin + cout) + (cin * cout if mix else 0) + px * cout)
    nbytes += 4 * (2 * cin + 4 * cout + BATCH * cout + (cout if mix else 0))
    return flops, nbytes


def check_blocks():
    """The block and split kernels against plain at their six sites; returns
    per-shape rows."""
    rows = []
    for i, (name, h, ca, cb, cout, calls) in enumerate(BLOCK_SHAPES):
        label = f"{name} {h}x{h}x{ca}" + (f"+{cb}" if cb else "") + f"->{cout}"
        for dtype in (torch.float32, torch.bfloat16):
            variants = [(True, False), (False, False)] + ([(True, True)] if i == 0 else [])
            for with_temb, rescale in variants:
                x, skip, kw = block_inputs(h, ca, cb, cout, dtype, seed=h * (ca + cb), with_temb=with_temb)
                kw["skip_rescale"] = rescale
                err = check_close(
                    f"{label} {dname(dtype)} temb={with_temb} skip_rescale={rescale}",
                    block_call(x, skip, kw), block_call(x, skip, kw, plain=True), dtype,
                )
                if not (with_temb and not rescale):
                    continue
                flops, nbytes = block_work(h, ca, cb, cout, dtype)
                bound_ms, bound_by = bound(flops, nbytes, dtype)
                xin = x if skip is None else torch.cat([x, skip], dim=-1)
                ws = kw["shortcut_w"]

                def library():  # no single PyTorch call computes the block
                    conv3x3_nhwc(conv3x3_nhwc(xin, kw["w0"]), kw["w1"])
                    if ws is not None:
                        torch.matmul(xin, ws)

                row = dict(
                    kernel=name, shape=f"{BATCH}x{h}x{h}x{ca}" + (f"+{cb}" if cb else "") + f"->{cout}",
                    dtype=dname(dtype), calls_per_forward=calls, max_abs_err=err, gflop=flops / 1e9,
                    bound_ms=bound_ms, bound_by=bound_by,
                    ms=time_ms(lambda: block_call(x, skip, kw)),
                    plain_ms=time_ms(lambda: block_call(x, skip, kw, plain=True)),
                    library_ms=time_ms(library),
                )
                print(
                    f"    time: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms,"
                    f" cuDNN convs + matmul {row['library_ms']:.4f} ms,"
                    f" bound {bound_ms:.4f} ms ({bound_by}), {flops / row['ms'] / 1e9:.2f} TFLOP/s",
                    flush=True,
                )
                rows.append(row)
    return rows


def check_ncsnpp_sites():
    """Kernels 1-3 against plain at the NCSN++ block variant's sites."""
    for h, c in NCSNPP_TAIL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, w, gamma, beta, bias, _ = tail_inputs(h, c, dtype, seed=h * c + 1)
            check_close(
                f"NCSN++ tail {h}x{h}x{c} {dname(dtype)}",
                fused_tail.gn_silu_conv3x3(x, w, gamma, beta, GROUPS, bias=bias),
                fused_tail.gn_silu_conv3x3_plain(x, w, gamma, beta, GROUPS, bias=bias), dtype,
            )
    for name, h, ca, cb, cout in NCSNPP_BLOCK_SHAPES:
        label = f"NCSN++ {name} {h}x{h}x{ca}" + (f"+{cb}" if cb else "") + f"->{cout}"
        for dtype in (torch.float32, torch.bfloat16):
            for with_temb in (True, False):
                x, skip, kw = block_inputs(h, ca, cb, cout, dtype, seed=h * (ca + cb) + 1, with_temb=with_temb)
                kw["skip_rescale"] = True
                check_close(
                    f"{label} {dname(dtype)} temb={with_temb} skip_rescale=True",
                    block_call(x, skip, kw), block_call(x, skip, kw, plain=True), dtype,
                )


# ---- the FIR resampling kernels ---------------------------------------------


def fir_library(name, x):
    """The one PyTorch call that computes the same resampling with [1,3,3,1]:
    a depthwise 4x4 transposed conv (stride 2) for the upsample, a depthwise
    4x4 conv (stride 2, padding 1) for the downsample, on the NCHW view."""
    C = x.shape[-1]
    k = torch.from_numpy(setup_kernel(fir.FIR_KERNEL, 4.0 if name == "fir_upsample2" else 1.0))
    w = k.to(x.device, x.dtype)[None, None].repeat(C, 1, 1, 1)
    xc = x.permute(0, 3, 1, 2)
    if name == "fir_upsample2":
        out = F.conv_transpose2d(xc, w, stride=2, padding=1, groups=C)
    else:
        out = F.conv2d(xc, w, stride=2, padding=1, groups=C)
    return out.permute(0, 2, 3, 1)


def check_fir():
    """Both FIR kernels against plain at the 20 shapes of one NCSN++
    forward, float32 (1e-5 of the largest magnitude) and bfloat16 (2e-2),
    and with a non-symmetric kernel at one shape each; returns per-shape
    rows with times (CUDA events over 100 calls) beside the plain version,
    the library call and the bound."""
    rows = []
    for name, h, c, calls in FIR_SHAPES:
        kernel, plain = WRAPPERS[name], getattr(fir, f"{name}_plain")
        out_h = 2 * h if name == "fir_upsample2" else h // 2
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device="cuda").manual_seed(h * c)
            x = (torch.randn(BATCH, h, h, c, generator=g, device="cuda") * 1.5 + 0.3).to(dtype)
            label = f"{name} {BATCH}x{h}x{h}x{c} {dname(dtype)}"
            err = check_close(label, kernel(x), plain(x), dtype, FIR_REL_TOL)
            if (h, c) in ((20, 6), (10, 256)):
                check_close(f"{label} k={ASYMMETRIC_FIR}", kernel(x, ASYMMETRIC_FIR), plain(x, ASYMMETRIC_FIR),
                            dtype, FIR_REL_TOL)
            lib_err = (fir_library(name, x).float() - plain(x).float()).abs().max().item()
            taps = 4 if name == "fir_upsample2" else 16
            out_elems = BATCH * out_h * out_h * c
            flops = 2 * taps * out_elems
            nbytes = itemsize(dtype) * (BATCH * h * h * c + out_elems)
            bound_ms, bound_by = bound(flops, nbytes, dtype)
            row = dict(
                kernel=name, shape=f"{BATCH}x{h}x{h}x{c}", dtype=dname(dtype), calls_per_forward=calls,
                max_abs_err=err, library_max_abs_err=lib_err, gflop=flops / 1e9, mbytes=nbytes / 1e6,
                bound_ms=bound_ms, bound_by=bound_by,
                ms=time_ms(lambda: kernel(x)), plain_ms=time_ms(lambda: plain(x)),
                library_ms=time_ms(lambda: fir_library(name, x)),
            )
            print(
                f"    time: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms,"
                f" depthwise cuDNN {row['library_ms']:.4f} ms (max diff {lib_err:.1e}),"
                f" bound {bound_ms:.4f} ms ({bound_by}), {nbytes / row['ms'] / 1e6:.1f} GB/s",
                flush=True,
            )
            rows.append(row)
    return rows


# ---- model paths ------------------------------------------------------------


def score_fn(model, sde, compute_dtype=None):
    """The conditional score as the JAX bench composes it."""
    raw = get_score_fn(sde, model, conditional=True, train=False, continuous=True, compute_dtype=compute_dtype)
    return get_conditional_score_fn(raw, "x")


def pc_sampler(config, sde, eps, shape, p_steps):
    s = config.sampling
    return get_pc_conditional_sampler(
        sde, shape, s.predictor, s.corrector, snr=s.snr, p_steps=p_steps,
        c_steps=s.n_steps_each, denoise=s.noise_removal, eps=eps,
    )


def rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def norm_rel_err(got, want):
    return ((got - want).norm() / want.norm()).item()


def agreement(label, config_on, config_off, model, batch, compute_dtype, tol, plain_off=False):
    """The same weights with the kernels on (``config_on``) and off
    (``config_off``, and with ``plain_off`` every kernel call site on its
    plain version): the score on the sampler's own input at t = 0.5 (x_t
    and y_t drawn from the SDE's marginals), a 3-step sample, and the raw
    network output on the clean batch.

    Float32: all three on against off, largest difference over largest
    magnitude, at ``tol``.

    Bfloat16: the two paths round at other places, and this network turns
    one bfloat16 step anywhere into ~1e-2 at its output; the kernel path
    differs from itself with the plain versions as much as from the unfused
    path (``*_floor`` below), so the largest single difference measures the
    network, not the kernels.  The score is held by norm (||on - off|| /
    ||off||) at ``tol``, the sample as in float32, and the raw output against
    the float32 network: the kernel path no further from it than the
    unfused path (norm, within 10%).  Every other difference is reported.
    """
    t = time.perf_counter()
    model_off = create_model(config_off, "cuda")
    model_off.load_state_dict(model.state_dict())
    sde, eps = sampler_sde(config_on)
    vec_t = torch.full((BATCH,), 0.5, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(2)
    x_t, y_t = (
        sde[k].marginal_prob(batch[k], vec_t)[0]
        + batch_mul(sde[k].marginal_prob(batch[k], vec_t)[1], torch.randn(batch[k].shape, generator=g, device="cuda"))
        for k in ("x", "y")
    )
    short = pc_sampler(config_on, sde, eps, tuple(batch["x"].shape), p_steps=3)
    inputs, labels = {"x": batch["x"], "y": batch["y"]}, vec_t * 999

    def run(m):
        score = score_fn(m, sde, compute_dtype)(x_t, y_t, vec_t)
        sample, _ = short(torch.Generator(device="cuda").manual_seed(1), score_fn(m, sde, compute_dtype), batch["y"])
        return score, sample, get_model_fn(m, compute_dtype=compute_dtype)(inputs, labels)

    score_on, s_got, raw_on = run(model)
    with plain_versions() if plain_off else contextlib.nullcontext():
        score_off, s_want, raw_off = run(model_off)
    r = dict(
        path=label, tol=tol,
        score_rel_err=rel_err(score_on, score_off), score_norm_rel_err=norm_rel_err(score_on, score_off),
        sample_rel_err=rel_err(s_got, s_want),
        raw_forward_rel_err=max(rel_err(raw_on[k], raw_off[k]) for k in inputs),
    )
    msg = (
        f"score rel err {r['score_rel_err']:.3e} (norm {r['score_norm_rel_err']:.3e}), 3-step sample rel err"
        f" {r['sample_rel_err']:.3e}, raw forward rel err {r['raw_forward_rel_err']:.3e}"
    )
    if compute_dtype is None:
        ok = max(r["score_rel_err"], r["sample_rel_err"], r["raw_forward_rel_err"]) <= tol
        msg += f" (tol {tol:.0e})"
    else:
        with plain_versions():
            score_plain = score_fn(model, sde, compute_dtype)(x_t, y_t, vec_t)
            raw_plain = get_model_fn(model, compute_dtype=compute_dtype)(inputs, labels)
        ref = get_model_fn(model_off)(inputs, labels)  # the float32 network
        r.update(
            score_floor_rel_err=rel_err(score_on, score_plain),
            score_floor_norm_rel_err=norm_rel_err(score_on, score_plain),
            raw_forward_floor_rel_err=max(rel_err(raw_on[k], raw_plain[k]) for k in inputs),
            raw_on_vs_float32=max(norm_rel_err(raw_on[k], ref[k]) for k in inputs),
            raw_off_vs_float32=max(norm_rel_err(raw_off[k], ref[k]) for k in inputs),
        )
        ok = (
            r["score_norm_rel_err"] <= tol
            and r["sample_rel_err"] <= tol
            and r["raw_on_vs_float32"] <= 1.1 * r["raw_off_vs_float32"]
        )
        msg += (
            f"; the kernel path against its plain versions: score rel err {r['score_floor_rel_err']:.3e}"
            f" (norm {r['score_floor_norm_rel_err']:.3e}), raw forward rel err {r['raw_forward_floor_rel_err']:.3e};"
            f" raw forward against the float32 network (norm): on {r['raw_on_vs_float32']:.3e},"
            f" off {r['raw_off_vs_float32']:.3e} (tol: score norm and sample {tol:.0e}, on <= 1.1x off)"
        )
    phase("agreement", t, f"{label}: kernels on vs off: {msg} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{label}: the kernel path disagrees with the unfused path")
    return r


def run_sampler(label, sample, per_forward, steps):
    """Run ``sample()`` with every kernel counter at 0; check the counts and
    the samples."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in WRAPPERS.values():
        fn.launches = 0
    t = time.perf_counter()
    samples = sample()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {name: fn.launches for name, fn in WRAPPERS.items()}
    expected = {name: per_forward.get(name, 0) * 2 * steps for name in WRAPPERS}
    finite = bool(torch.isfinite(samples).all())
    result = dict(
        path=label, steps=steps, wall_s=wall, images_per_s=BATCH / wall,
        ms_per_score_eval=wall / (2 * steps) * 1e3,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30, launches=launches,
    )
    phase(
        "main", t,
        f"{label}: {steps}-step conditional PC sampler: {wall:.3f} s wall, {result['images_per_s']:.4f} images/s,"
        f" {result['ms_per_score_eval']:.3f} ms per score evaluation, peak {result['peak_gib']:.3f} GiB;"
        f" samples {tuple(samples.shape)} finite={finite} range [{samples.min().item():.3f},"
        f" {samples.max().item():.3f}]; launches {launches} (expected {expected})",
    )
    if tuple(samples.shape) != (8, 160, 160, 3) or not finite:
        raise RuntimeError(f"{label}: samples are not finite or not shaped (8, 160, 160, 3)")
    if launches != expected:
        raise RuntimeError(f"{label}: launches {launches}, expected {expected}")
    return result


def per_forward_row(name, route_source, replaces, launches, rows, dtype, calls_key, unit):
    """One kernel's line: sums over the calls of one forward at ``dtype``."""
    rows = [r for r in rows if r["dtype"] == dname(dtype) and r[calls_key] > 0]
    total = lambda key: sum(r[key] * r[calls_key] for r in rows)  # noqa: E731
    return dict(
        name=name, route="cuda", source=route_source, replaces=replaces, launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=total("ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
        bound_by="operations" if all(r["bound_by"] == "operations" for r in rows) else "bytes",
        library_ms=total("library_ms"), unit=unit,
    )


def main() -> int:
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    phase(
        "device", t0,
        f"{kind} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}",
    )

    # ---- build: one nvcc for each source, started together ----------------
    t = time.perf_counter()
    loaders = {
        "gn_silu_conv3x3": fused_tail.load_library,
        "resblock_fused": fused_block.load_library,
        "fir_resample": fir.load_library,
    }
    with ThreadPoolExecutor(len(loaders)) as pool:
        built = dict(zip(loaders, pool.map(lambda load: load(), loaders.values())))
    phase("build", t, "; ".join(
        f"{name}: nvcc {b.build_seconds:.2f} s -> {os.path.relpath(b.path, REPO)}" for name, b in built.items()
    ))
    for name, b in built.items():
        for ln in b.build_log.splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                print(f"  ptxas {name}: {ln.strip()}", flush=True)

    t = time.perf_counter()
    tail_rows = check_tail()
    block_rows = check_blocks()
    check_ncsnpp_sites()
    fir_rows = check_fir()
    phase("kernel", t, "every kernel agrees with its plain version at every shape")

    # ---- set-up: the batch and one set of weights ---------------------------
    t = time.perf_counter()
    config = texture160_sr_cmde_bf16_block_config()
    config.data.base_dir = os.path.join(REPO, "datasets")
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(iter_test_batches(config)).items()}
    model = init_model_random(config, seed=config.seed, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    sde, eps = sampler_sde(config)
    shape = tuple(batch["x"].shape)
    phase("setup", t, f"texture160 batch {tuple(batch['y'].shape)}, ddpm_paired {n_params} params")

    tail_config = texture160_sr_cmde_config()  # fused_tail only
    tail_model = create_model(tail_config, "cuda")
    tail_model.load_state_dict(model.state_dict())
    off_config = texture160_sr_cmde_config()
    off_config.model.fused_tail = False
    agree = [
        agreement("float32 tail path", tail_config, off_config, tail_model, batch, None, REL_TOL[torch.float32]),
        agreement("float32 block path", config, off_config, model, batch, None, REL_TOL[torch.float32]),
        agreement("bfloat16 block path", config, off_config, model, batch, torch.bfloat16, BF16_AGREE_TOL),
    ]

    # ---- main: the new path, bfloat16, block and tail kernels -----------
    score = score_fn(model, sde, torch.bfloat16)
    sampler = pc_sampler(config, sde, eps, shape, p_steps=STEPS)
    gen = torch.Generator(device="cuda").manual_seed(config.seed)
    main_new = run_sampler(
        "bfloat16 fused_block+fused_tail", lambda: sampler(gen, score, batch["y"])[0],
        PER_FORWARD_BLOCK_PATH, STEPS,
    )
    del score

    # ---- main: the float32 tail path, fewer steps ---------------------
    tail_sample = get_conditional_sampling_fn(tail_config, sde, shape, eps, p_steps=TAIL_PATH_STEPS)
    gen = torch.Generator(device="cuda").manual_seed(config.seed)
    main_tail = run_sampler(
        "float32 fused_tail", lambda: tail_sample(gen, tail_model, batch["y"])[0],
        PER_FORWARD_TAIL_PATH, TAIL_PATH_STEPS,
    )
    del model, tail_model

    # ---- the DF2K direct 4x NCSN++ path: set-up and agreement ---------------
    t = time.perf_counter()
    kx_config = texture160_kxsr_ncsnpp_config()
    kx_config.data.base_dir = os.path.join(REPO, "datasets")
    kx_batch = {k: torch.from_numpy(v).cuda() for k, v in next(iter_test_batches(kx_config)).items()}
    kx_model = init_model_random(kx_config, seed=kx_config.seed, device="cuda")
    kx_params = sum(p.numel() for p in kx_model.parameters()) + kx_model.unet.fourier.W.numel()
    kx_sde, kx_eps = sampler_sde(kx_config)
    phase(
        "setup", t,
        f"texture160 LRHR batch x {tuple(kx_batch['x'].shape)} y {tuple(kx_batch['y'].shape)},"
        f" ncsnpp_KxSR {kx_params} params (the Fourier W included), sigma_y,max {kx_sde['y'].sigma_max:.4f}",
    )
    block_config = texture160_kxsr_ncsnpp_block_config()
    block_model = create_model(block_config, "cuda")
    block_model.load_state_dict(kx_model.state_dict())
    agree += [
        agreement("float32 NCSN++ FIR kernels vs plain", kx_config, kx_config, kx_model, kx_batch, None,
                  REL_TOL[torch.float32], plain_off=True),
        agreement("float32 NCSN++ block variant", block_config, kx_config, block_model, kx_batch, None,
                  REL_TOL[torch.float32]),
    ]
    del block_model

    # ---- main: the NCSN++ path, float32, the FIR kernels -------------------
    kx_sample = get_conditional_sampling_fn(kx_config, kx_sde, tuple(kx_batch["x"].shape), kx_eps, p_steps=STEPS)
    gen = torch.Generator(device="cuda").manual_seed(kx_config.seed)
    main_ncsnpp = run_sampler(
        "float32 NCSN++ DF2K direct 4x", lambda: kx_sample(gen, kx_model, kx_batch["y"])[0],
        PER_FORWARD_NCSNPP_PATH, STEPS,
    )

    bf16 = torch.bfloat16
    tail_line = per_forward_row(
        "gn_silu_conv3x3", "conditional_score_diffusion_tpu_torch/csrc/gn_silu_conv3x3.cu",
        "conditional_score_diffusion_tpu/ops/fused_block_pallas.py:107",
        main_new["launches"]["gn_silu_conv3x3"], tail_rows, bf16, "calls_per_forward_block_path",
        "one forward of the bfloat16 block path: the 5 tails at 20x20x192, B=8; library_ms is cuDNN's conv alone",
    )
    tail_line["float32_tail_path"] = per_forward_row(
        "gn_silu_conv3x3", tail_line["source"], tail_line["replaces"],
        main_tail["launches"]["gn_silu_conv3x3"], tail_rows, torch.float32, "calls_per_forward_tail_path",
        "one forward of the float32 tail path: the 17 gated tails, B=8",
    )
    kernels = [tail_line]
    for name, line in (("resblock_fused", 269), ("resblock_fused_split", 462)):
        rows = [r for r in block_rows if r["kernel"] == name]
        k = per_forward_row(
            name, "conditional_score_diffusion_tpu_torch/csrc/resblock_fused.cu",
            f"conditional_score_diffusion_tpu/ops/fused_block_pallas.py:{line}",
            main_new["launches"][name], rows, bf16, "calls_per_forward",
            f"one forward of the bfloat16 block path: its {PER_FORWARD_BLOCK_PATH[name]} calls, B=8;"
            " library_ms is cuDNN's two convs + the shortcut matmul",
        )
        k["float32"] = per_forward_row(
            name, k["source"], k["replaces"], k["launches"], rows, torch.float32, "calls_per_forward",
            "the same calls in float32",
        )
        kernels.append(k)
    for name, line in (("fir_upsample2", 131), ("fir_downsample2", 156)):
        rows = [r for r in fir_rows if r["kernel"] == name]
        k = per_forward_row(
            name, "conditional_score_diffusion_tpu_torch/csrc/fir_resample.cu",
            f"conditional_score_diffusion_tpu/ops/pallas_kernels.py:{line}",
            main_ncsnpp["launches"][name], rows, torch.float32, "calls_per_forward",
            f"one forward of the float32 NCSN++ path: its {PER_FORWARD_NCSNPP_PATH[name]} calls, B=8;"
            " library_ms is the depthwise 4x4 cuDNN call",
        )
        k["bfloat16"] = per_forward_row(
            name, k["source"], k["replaces"], k["launches"], rows, bf16, "calls_per_forward",
            "the same calls in bfloat16",
        )
        kernels.append(k)
    for k in kernels:
        k["per_shape"] = [
            r for r in tail_rows + block_rows + fir_rows if r.get("kernel", "gn_silu_conv3x3") == k["name"]
        ]
    paths = [main_new, main_tail, main_ncsnpp]
    print(json.dumps({"kernels": kernels, "paths": paths, "agreement": agree}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
