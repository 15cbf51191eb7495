#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what it computes.

    python3 chip_smoke.py

Phases, each printing its own line with its seconds:

1. device: needs a CUDA device (exits non-zero without one); prints the card's
   name and power limit as nvidia-smi gives them, and the TF32 switches
   (both off: the port runs float32 as float32).
2. build: builds both kernel sources (csrc/gn_silu_conv3x3.cu,
   csrc/resblock_fused.cu) with nvcc, in parallel, each with its seconds and
   its ptxas lines.
3. kernel: each kernel against its plain PyTorch version at the shapes the
   flagship sampler gives it (B=8, 32 groups), float32 (rel tol 1e-4) and
   bfloat16 (2e-2): the fused tail at 20x20x192, 10x10x288, 5x5x288, with
   and without temb; the whole-resblock kernels at their six sites (block
   10x10 192->288 with the NIN shortcut, 10x10 288->288, 5x5 288->288; split
   5x5 288+288, 10x10 288+288, 10x10 288+192 -> 288, where a 15-channel group
   straddles the concat), with and without temb and once with skip_rescale.
   Then each one's time, its plain version's, a library yardstick's and its
   bound, by CUDA events.
4. agreement: the same weights with the kernels on and off, for the
   float32 tail path and the new path (fused_block and fused_tail)
   in float32 and in bfloat16 compute: the score on the sampler's own input
   at t = 0.5, a 3-step sample and the raw network output on the clean
   batch; float32 at 1e-4, bfloat16 as `agreement` says (2e-2).
5. main (new path): texture160 test batch 0 (8 images, y = 8x SR
   degradation), the full-width ddpm_paired with seeded N(0, 0.02) weights,
   bfloat16 compute through `get_score_fn(compute_dtype=...)` ->
   `get_conditional_score_fn` -> `get_pc_conditional_sampler` (as the JAX
   bench composes it), fused_block and fused_tail on, 1000 steps.  Each
   kernel's launch counter, set to 0 just before, must read exactly its
   count per forward x 2 x 1000 just after.
6. main (the float32 tail path): the same batch and weights, float32,
   fused_tail only, through `get_conditional_sampling_fn`, 200 steps; the
   tail's counter must read 17 x 2 x 200.
7. result: a JSON line of the kernels, the nvidia-smi line, and last
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

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from conditional_score_diffusion_tpu_torch.configs import (  # noqa: E402
    texture160_sr_cmde_bf16_block_config,
    texture160_sr_cmde_config,
)
from conditional_score_diffusion_tpu_torch.data.pkl_datasets import iter_test_batches  # noqa: E402
from conditional_score_diffusion_tpu_torch.models import create_model, init_model_random, layers  # noqa: E402
from conditional_score_diffusion_tpu_torch.models.wrappers import (  # noqa: E402
    get_conditional_score_fn,
    get_model_fn,
    get_score_fn,
)
from conditional_score_diffusion_tpu_torch.ops import fused_block, fused_tail  # noqa: E402
from conditional_score_diffusion_tpu_torch.ops.fused_tail import conv3x3_nhwc  # noqa: E402
from conditional_score_diffusion_tpu_torch.sampling import (  # noqa: E402
    get_conditional_sampling_fn,
    get_pc_conditional_sampler,
)
from conditional_score_diffusion_tpu_torch.sde import batch_mul, build_sde  # noqa: E402

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
STEPS = 1000  # the new path: the flagship's full step count
TAIL_PATH_STEPS = 200  # the float32 tail path, cut from 1000 to keep the run short
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Kernels on against off, bfloat16 compute (see `agreement`).
BF16_AGREE_TOL = 2e-2

WRAPPERS = {
    "gn_silu_conv3x3": fused_tail.gn_silu_conv3x3,
    "resblock_fused": fused_block.resblock_fused,
    "resblock_fused_split": fused_block.resblock_fused_split,
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


def check_close(label, got, want, dtype):
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != dtype:
        raise RuntimeError(f"{label}: kernel output {got.shape} {got.dtype}, want {want.shape} {dtype}")
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    ok = err <= REL_TOL[dtype] * scale
    print(
        f"  {label}: max_abs_err {err:.3e} rel {err / scale:.3e} tol rel {REL_TOL[dtype]:.0e}"
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


@contextlib.contextmanager
def plain_versions():
    """The model's kernel call sites take the plain versions, on the card."""
    real = {name: getattr(layers, name) for name in WRAPPERS}
    layers.gn_silu_conv3x3 = fused_tail.gn_silu_conv3x3_plain
    layers.resblock_fused = fused_block.resblock_fused_plain
    layers.resblock_fused_split = fused_block.resblock_fused_split_plain
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(layers, name, fn)


def agreement(label, config_on, config_off, model, batch, compute_dtype, tol):
    """The same weights with the kernels on (``config_on``) and off
    (``config_off``): the score on the sampler's own input at t = 0.5
    (x_t and y_t drawn from the SDE's marginals), a 3-step sample, and the
    raw network output on the clean batch.

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
    sde, eps = build_sde(config_on)
    vec_t = torch.full((BATCH,), 0.5, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(2)
    x_t, y_t = (
        sde[k].marginal_prob(batch[k], vec_t)[0]
        + batch_mul(sde[k].marginal_prob(batch[k], vec_t)[1], torch.randn(batch[k].shape, generator=g, device="cuda"))
        for k in ("x", "y")
    )
    score_on = score_fn(model, sde, compute_dtype)(x_t, y_t, vec_t)
    score_off = score_fn(model_off, sde, compute_dtype)(x_t, y_t, vec_t)
    short = pc_sampler(config_on, sde, eps, tuple(batch["y"].shape), p_steps=3)
    s_got, _ = short(torch.Generator(device="cuda").manual_seed(1), score_fn(model, sde, compute_dtype), batch["y"])
    s_want, _ = short(torch.Generator(device="cuda").manual_seed(1), score_fn(model_off, sde, compute_dtype), batch["y"])
    inputs, labels = {"x": batch["x"], "y": batch["y"]}, vec_t * 999
    raw_on = get_model_fn(model, compute_dtype=compute_dtype)(inputs, labels)
    raw_off = get_model_fn(model_off, compute_dtype=compute_dtype)(inputs, labels)
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
        f"{label}: {steps}-step CMDE sampler: {wall:.3f} s wall, {result['images_per_s']:.4f} images/s,"
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
    with ThreadPoolExecutor(2) as pool:
        built = dict(zip(("gn_silu_conv3x3", "resblock_fused"), pool.map(
            lambda load: load(), (fused_tail.load_library, fused_block.load_library)
        )))
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
    phase("kernel", t, "every kernel agrees with its plain version at every shape")

    # ---- set-up: the batch and one set of weights ---------------------------
    t = time.perf_counter()
    config = texture160_sr_cmde_bf16_block_config()
    config.data.base_dir = os.path.join(REPO, "datasets")
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(iter_test_batches(config)).items()}
    model = init_model_random(config, seed=config.seed, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    sde, eps = build_sde(config)
    shape = (config.eval.batch_size,) + tuple(batch["y"].shape[1:])
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
    for k in kernels:
        k["per_shape"] = [r for r in tail_rows + block_rows if r.get("kernel", "gn_silu_conv3x3") == k["name"]]
    print(json.dumps({"kernels": kernels, "paths": [main_new, main_tail], "agreement": agree}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
