#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what it computes.

    python3 chip_smoke.py

Phases, each printing its own line with its seconds:

1. device: needs a CUDA device (exits non-zero without one); prints the card's
   name and power limit as nvidia-smi gives them, and the TF32 switches
   (both off: the port runs float32 as float32).
2. build: builds the fused-tail kernel (csrc/gn_silu_conv3x3.cu) with nvcc.
3. kernel: the kernel against its plain PyTorch version at the three shapes
   the flagship sampler gives it (B=8, 32 groups: 20x20x192, 10x10x288,
   5x5x288), float32 and bfloat16, with and without temb; then its time, the
   plain version's, and cuDNN's time for the conv alone, by CUDA events.
4. main path: texture160 test batch 0 (8 images, y = 8x SR degradation), the
   full-width ddpm_paired with seeded N(0, 0.02) weights, and the 1000-step
   CMDE conditional PC sampler through `get_conditional_sampling_fn`.  The
   tail kernel's launch counter must grow by exactly 17 x 2 x 1000.  Before
   it, one forward and a 3-step sample with the kernel are held against the
   same model with the plain tail.
5. result: a JSON line of the kernels, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from conditional_score_diffusion_tpu_torch.configs import texture160_sr_cmde_config  # noqa: E402
from conditional_score_diffusion_tpu_torch.data.pkl_datasets import iter_test_batches  # noqa: E402
from conditional_score_diffusion_tpu_torch.models import create_model, init_model_random  # noqa: E402
from conditional_score_diffusion_tpu_torch.ops import fused_tail  # noqa: E402
from conditional_score_diffusion_tpu_torch.ops.fused_tail import conv3x3_nhwc  # noqa: E402
from conditional_score_diffusion_tpu_torch.sampling import get_conditional_sampling_fn  # noqa: E402
from conditional_score_diffusion_tpu_torch.sde import build_sde  # noqa: E402

# Published dense peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet).
PEAK_FP32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# Gated tails of one flagship forward: (H, C, calls per forward).
TAIL_SHAPES = [(20, 192, 5), (10, 288, 5), (5, 288, 7)]
BATCH, GROUPS = 8, 32
STEPS = 1000
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


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


def tail_inputs(h, c, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(BATCH, h, h, c, generator=g, device="cuda") * 1.5 + 0.3).to(dtype)
    w = (torch.randn(c, c, 3, 3, generator=g, device="cuda") / (9 * c) ** 0.5).to(dtype)
    gamma = 1.0 + 0.1 * torch.randn(c, generator=g, device="cuda")
    beta = 0.1 * torch.randn(c, generator=g, device="cuda")
    bias = 0.1 * torch.randn(c, generator=g, device="cuda")
    temb = torch.randn(BATCH, c, generator=g, device="cuda")
    return x, w, gamma, beta, bias, temb


def tail_bound_ms(h, c, dtype):
    """Least time for one call: operations over the peak rate of the type,
    or bytes (x, w, gamma, beta, bias read once, out written once) over the
    memory rate, whichever is larger."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    flops = 2 * 9 * BATCH * h * h * c * c
    nbytes = itemsize * (2 * BATCH * h * h * c + 9 * c * c) + 4 * 3 * c
    peak = PEAK_FP32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops


def check_kernel():
    """Kernel against plain at the slice's shapes; returns per-shape numbers."""
    rows = []
    for h, c, calls in TAIL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for with_temb in (False, True):
                x, w, gamma, beta, bias, temb = tail_inputs(h, c, dtype, seed=h * c)
                temb = temb if with_temb else None
                got = fused_tail.gn_silu_conv3x3(x, w, gamma, beta, GROUPS, bias=bias, temb=temb)
                want = fused_tail.gn_silu_conv3x3_plain(x, w, gamma, beta, GROUPS, bias=bias, temb=temb)
                torch.cuda.synchronize()
                if got.shape != want.shape or got.dtype != dtype:
                    raise RuntimeError(f"kernel output {got.shape} {got.dtype}, want {want.shape} {dtype}")
                err = (got.float() - want.float()).abs().max().item()
                scale = want.float().abs().max().item()
                ok = err <= REL_TOL[dtype] * scale
                print(
                    f"  {h}x{h}x{c} {str(dtype)[6:]} temb={with_temb}: max_abs_err {err:.3e}"
                    f" rel {err / scale:.3e} tol rel {REL_TOL[dtype]:.0e} {'ok' if ok else 'FAIL'}",
                    flush=True,
                )
                if not ok:
                    raise RuntimeError(f"kernel disagrees with its plain version at {h}x{h}x{c} {dtype}")
                if with_temb:
                    continue
                bound, bound_by, flops = tail_bound_ms(h, c, dtype)
                row = dict(
                    shape=f"{BATCH}x{h}x{h}x{c}", dtype=str(dtype)[6:], calls_per_forward=calls,
                    max_abs_err=err, gflop=flops / 1e9, bound_ms=bound, bound_by=bound_by,
                    ms=time_ms(lambda: fused_tail.gn_silu_conv3x3(x, w, gamma, beta, GROUPS, bias=bias)),
                    plain_ms=time_ms(lambda: fused_tail.gn_silu_conv3x3_plain(x, w, gamma, beta, GROUPS, bias=bias)),
                    # no single PyTorch call computes GN+SiLU+conv: cuDNN's conv alone
                    library_conv_only_ms=time_ms(lambda: conv3x3_nhwc(x, w, bias.to(dtype))),
                )
                print(
                    f"    time: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms,"
                    f" cuDNN conv only {row['library_conv_only_ms']:.4f} ms,"
                    f" bound {bound:.4f} ms ({bound_by}), {flops / row['ms'] / 1e9:.2f} TFLOP/s",
                    flush=True,
                )
                rows.append(row)
    return rows


def score_forward(model, batch, t):
    with torch.no_grad():
        return model({"x": batch["x"], "y": batch["y"]}, t * 999)


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

    t = time.perf_counter()
    built = fused_tail.load_library()
    ptxas = [ln.strip() for ln in built.build_log.splitlines() if "registers" in ln or "spill" in ln]
    phase("build", t, f"nvcc {built.build_seconds:.2f} s -> {os.path.relpath(built.path, REPO)}")
    for ln in ptxas:
        print(f"  ptxas: {ln}", flush=True)

    t = time.perf_counter()
    rows = check_kernel()
    phase("kernel", t, "kernel agrees with its plain version at every shape")

    # ---- main path ------------------------------------------------------
    t = time.perf_counter()
    config = texture160_sr_cmde_config()
    config.data.base_dir = os.path.join(REPO, "datasets")
    batch_np = next(iter_test_batches(config))
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
    model = init_model_random(config, seed=config.seed, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    sde, eps = build_sde(config)
    shape = (config.eval.batch_size,) + tuple(batch["y"].shape[1:])
    phase("setup", t, f"texture160 batch {tuple(batch['y'].shape)}, ddpm_paired {n_params} params")

    # the same weights with the plain tail, held against the kernel path
    t = time.perf_counter()
    config_plain = texture160_sr_cmde_config()
    config_plain.model.fused_tail = False
    model_plain = create_model(config_plain, "cuda")
    model_plain.load_state_dict(model.state_dict())
    vec_t = torch.full((BATCH,), 0.5, device="cuda")
    got, want = score_forward(model, batch, vec_t), score_forward(model_plain, batch, vec_t)
    fwd_err = max((got[k] - want[k]).abs().max().item() / want[k].abs().max().item() for k in got)
    short = get_conditional_sampling_fn(config, sde, shape, eps, p_steps=3)
    s_got, _ = short(torch.Generator(device="cuda").manual_seed(1), model, batch["y"])
    s_want, _ = short(torch.Generator(device="cuda").manual_seed(1), model_plain, batch["y"])
    smp_err = ((s_got - s_want).abs().max() / s_want.abs().max()).item()
    torch.cuda.synchronize()
    ok = fwd_err <= 1e-4 and smp_err <= 1e-4
    phase(
        "agreement", t,
        f"kernel path vs plain tail: forward rel err {fwd_err:.3e}, 3-step sample rel err"
        f" {smp_err:.3e} (tol 1e-4) {'ok' if ok else 'FAIL'}",
    )
    if not ok:
        raise RuntimeError("the kernel path disagrees with the plain tail")
    del model_plain

    sample = get_conditional_sampling_fn(config, sde, shape, eps)
    gen = torch.Generator(device="cuda").manual_seed(config.seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_tail.gn_silu_conv3x3.launches = 0
    t = time.perf_counter()
    samples, info = sample(gen, model, batch["y"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = fused_tail.gn_silu_conv3x3.launches
    expected = 17 * 2 * STEPS
    finite = bool(torch.isfinite(samples).all())
    phase(
        "main", t,
        f"{STEPS}-step CMDE sampler: {wall:.3f} s wall, {shape[0] / wall:.4f} images/s,"
        f" {wall / (2 * STEPS) * 1e3:.3f} ms per score evaluation, peak"
        f" {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; samples {tuple(samples.shape)}"
        f" finite={finite} range [{samples.min().item():.3f}, {samples.max().item():.3f}];"
        f" gn_silu_conv3x3 launches {launches} (expected {expected})",
    )
    if tuple(samples.shape) != (8, 160, 160, 3) or not finite:
        raise RuntimeError("samples are not finite or not shaped (8, 160, 160, 3)")
    if launches != expected:
        raise RuntimeError(f"fused tail launched {launches} times, expected {expected}")

    fp32 = [r for r in rows if r["dtype"] == "float32"]
    per_forward = lambda key: sum(r[key] * r["calls_per_forward"] for r in fp32)
    kernels = [
        dict(
            name="gn_silu_conv3x3",
            route="cuda",
            source="conditional_score_diffusion_tpu_torch/csrc/gn_silu_conv3x3.cu",
            replaces="conditional_score_diffusion_tpu/ops/fused_block_pallas.py:107",
            launches=launches,
            max_abs_err=max(r["max_abs_err"] for r in fp32),
            ms=per_forward("ms"),
            plain_ms=per_forward("plain_ms"),
            bound_ms=per_forward("bound_ms"),
            bound_by="operations" if all(r["bound_by"] == "operations" for r in fp32) else "bytes",
            library_ms=per_forward("library_conv_only_ms"),
            unit="one forward: the 17 gated tails, float32, B=8; library_ms is cuDNN's conv alone",
            per_shape=rows,
        )
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
