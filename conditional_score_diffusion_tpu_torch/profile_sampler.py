"""Where the flagship CMDE sampler's time goes on the card.

    python -m conditional_score_diffusion_tpu_torch.profile_sampler           # on a GPU
    python -m conditional_score_diffusion_tpu_torch.profile_sampler --count   # anywhere

``--count`` builds the full-width ``ddpm_paired`` on the meta device and
counts one forward's floating-point operations by layer kind (3x3 convs,
the gated resblock tails among them, dense layers, attention), from the
shapes alone.

Without it, on a CUDA device: the texture160 batch, seeded N(0, 0.02)
weights, and ``--steps`` sampler steps (2 score evaluations each) timed by
the host clock after a synchronize, with the fused tail on and off in turns
(on, off, off, on, ...); then one profiled window of 2 steps with the tail
on, whose kernels are listed by device time.  TF32 is off, as in the port's
float32 runs.  The card's name and power limit are printed first.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import time

import torch

from .configs import texture160_sr_cmde_config
from .data.pkl_datasets import iter_test_batches
from .models import create_model, init_model_random
from .models.layers import AttnBlock, Conv3x3, Dense, ResnetBlockDDPM, fused_tail_candidate_policy
from .sampling import get_conditional_sampling_fn
from .sde import build_sde

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def count_flops(config, batch: int) -> dict:
    """Operations of one forward, by layer kind, from shapes on the meta device."""
    config.model.fused_tail = False
    model = create_model(config, "meta")
    counts = {"conv3x3": 0, "conv3x3_gated_tails": 0, "gated_tail_calls": 0, "dense": 0, "attention": 0}
    tails = {id(m.conv1) for m in model.modules() if isinstance(m, ResnetBlockDDPM)}

    def conv_hook(mod, args, out):
        flops = 2 * out.numel() * mod.weight.shape[1] * 9
        counts["conv3x3"] += flops
        if id(mod) in tails and fused_tail_candidate_policy(out.shape, out.shape[-1]):
            counts["conv3x3_gated_tails"] += flops
            counts["gated_tail_calls"] += 1

    def dense_hook(mod, args, out):
        counts["dense"] += 2 * out.numel() * mod.weight.shape[1]

    def attn_hook(mod, args, out):
        B, H, W, C = out.shape
        counts["attention"] += 2 * 2 * B * (H * W) ** 2 * C  # q.k and w.v

    for m in model.modules():
        if isinstance(m, Conv3x3):
            m.register_forward_hook(conv_hook)
        elif isinstance(m, Dense):
            m.register_forward_hook(dense_hook)
        elif isinstance(m, AttnBlock):
            m.register_forward_hook(attn_hook)
    s = config.data.image_size
    x = torch.empty(batch, s, s, 3, device="meta")
    with torch.no_grad():
        model({"x": x, "y": x}, torch.empty(batch, device="meta"))
    counts["total"] = counts["conv3x3"] + counts["dense"] + counts["attention"]
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--count", action="store_true", help="count one forward's operations and stop")
    ap.add_argument("--steps", type=int, default=20, help="sampler steps per timed run")
    ap.add_argument("--pairs", type=int, default=3, help="(on, off) pairs of timed runs")
    args = ap.parse_args()

    config = texture160_sr_cmde_config()
    batch_size = config.eval.batch_size
    counts = count_flops(texture160_sr_cmde_config(), batch_size)
    print(f"one forward at B={batch_size}: " + ", ".join(
        f"{k} {v / 1e9:.3f} GFLOP" if k != "gated_tail_calls" else f"{k} {v}" for k, v in counts.items()
    ), flush=True)
    if args.count:
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("profile_sampler: no CUDA device (use --count for the operation count)")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"card: {smi}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    config.data.base_dir = os.path.join(REPO, "datasets")
    y = torch.from_numpy(next(iter_test_batches(config))["y"]).cuda()
    models = {True: init_model_random(config, seed=config.seed, device="cuda")}
    config_off = texture160_sr_cmde_config()
    config_off.model.fused_tail = False
    models[False] = create_model(config_off, "cuda")
    models[False].load_state_dict(models[True].state_dict())
    sde, eps = build_sde(config)
    sample = get_conditional_sampling_fn(config, sde, tuple(y.shape), eps, p_steps=args.steps)

    def run(fused):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample(torch.Generator(device="cuda").manual_seed(0), models[fused], y)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / (2 * args.steps) * 1e3

    run(True), run(False)  # warm-up: cuDNN plans, kernel build
    times = {True: [], False: []}
    for i in range(args.pairs):
        order = (True, False) if i % 2 == 0 else (False, True)
        for fused in order:
            times[fused].append(run(fused))
    for fused in (True, False):
        ts = times[fused]
        print(
            f"fused_tail={fused}: ms per score evaluation {['%.3f' % t for t in ts]},"
            f" median {statistics.median(ts):.3f}",
            flush=True,
        )

    short = get_conditional_sampling_fn(config, sde, tuple(y.shape), eps, p_steps=2)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        short(torch.Generator(device="cuda").manual_seed(0), models[True], y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in events)
    print(
        f"profiled 2 steps (4 score evaluations): wall {wall * 1e3:.3f} ms, kernels {device_us / 1e3:.3f} ms"
        f" of device time, busy share {device_us / 1e6 / wall:.3f}",
        flush=True,
    )
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:25]:
        print(
            f"  {e.self_device_time_total / 1e3:10.3f} ms {e.count:6d}x  {e.key[:110]}",
            flush=True,
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
