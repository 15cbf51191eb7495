"""Where the samplers' time goes on the card.

    python -m conditional_score_diffusion_tpu_torch.profile_sampler                 # on a GPU
    python -m conditional_score_diffusion_tpu_torch.profile_sampler --path tail     # float32
    python -m conditional_score_diffusion_tpu_torch.profile_sampler --path ncsnpp   # NCSN++
    python -m conditional_score_diffusion_tpu_torch.profile_sampler --path harness  # texture64 EMA
    python -m conditional_score_diffusion_tpu_torch.profile_sampler --count         # anywhere

``--count`` builds the path's full-width model on the meta device and counts
one forward's floating-point operations by layer kind (3x3 and 1x1 convs,
the gated resblock tails and the gated whole blocks among them, dense
layers, attention, the FIR resampling), and the FIR calls, from the shapes
alone.

Without it, on a CUDA device: the texture160 batch, seeded N(0, 0.02)
weights, and ``--steps`` sampler steps (2 score evaluations each) timed by
the host clock after a synchronize, with the kernels on and off in turns
(on, off, off, on, ...); then one profiled window of 2 steps with them on
and one with them off, whose kernels are listed by device time.
``--path block`` (the default) is the JAX bench's flagship: bfloat16
compute, ``fused_block`` and ``fused_tail`` (off: both off, still
bfloat16); ``--path tail`` is the float32 path with ``fused_tail`` alone;
``--path ncsnpp`` is the DF2K direct 4x NCSN++ sampler in float32 with the
FIR kernels (off: their plain versions); ``--path harness`` is the --mode
test harness's sampler, the trained texture64 EMA (not random weights) on
its test batch of 16 in float32 with ``fused_tail``.  TF32 is off, as in the port's
float32 runs.  The card's name and power limit are printed first.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import statistics
import subprocess
import time

import torch

from .configs import (
    texture160_kxsr_ncsnpp_config,
    texture160_sr_cmde_bf16_block_config,
    texture160_sr_cmde_config,
    texture64_sr_cmde_test_config,
)
from .data.pkl_datasets import iter_test_batches
from .eval.harness import load_model
from .models import create_model, init_model_random, layers
from .models.layers import (
    NIN,
    Conv1x1,
    Conv3x3,
    Dense,
    FusedResblock,
    SplitNIN,
    fused_block_candidate_policy,
    fused_tail_candidate_policy,
)
from .models.layerspp import AttnBlockpp
from .models.wrappers import get_conditional_score_fn, get_score_fn
from .ops import conv3x3, fir, fused_block, fused_tail
from .profiling import attribute_profile, device_ms, kernel_launches, per_unit_lines
from .sampling import get_pc_conditional_sampler
from .sde import build_sde
from .sde.factory import is_conditional_config
from .training.schedules import is_decreasing_variance, sigma_y_at_step

PATHS = {
    "block": texture160_sr_cmde_bf16_block_config,
    "tail": texture160_sr_cmde_config,
    "ncsnpp": texture160_kxsr_ncsnpp_config,
    "harness": texture64_sr_cmde_test_config,
}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def plain_versions():
    """Every kernel call site of the models takes its kernel's plain
    version, also on the card (the "kernels off" side of a comparison)."""
    patched = [
        (layers, "gn_silu_conv3x3", fused_tail.gn_silu_conv3x3_plain),
        (layers, "resblock_fused", fused_block.resblock_fused_plain),
        (layers, "resblock_fused_split", fused_block.resblock_fused_split_plain),
        (fir, "fir_upsample2", fir.fir_upsample2_plain),
        (fir, "fir_downsample2", fir.fir_downsample2_plain),
        (layers, "conv3x3", conv3x3.conv3x3_plain),
    ]
    real = [(mod, name, getattr(mod, name)) for mod, name, _ in patched]
    for mod, name, fn in patched:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in real:
            setattr(mod, name, fn)


def sampler_sde(config):
    """The recipe's SDE as its sampler runs it: for VS-CMDE, sigma_y as the
    schedule leaves it at ``model.reach_target_steps`` (the JAX harness
    restores it at the checkpoint's step)."""
    if is_decreasing_variance(config):
        smin, smax = sigma_y_at_step(config, config.model.reach_target_steps)
        return build_sde(config, sigma_min_y=smin, sigma_max_y=smax)
    return build_sde(config)


def path_inputs(config, batch: int, device):
    """Empty inputs of the recipe's shapes: ``{'x', 'y'}`` with y at x's size,
    or at 1/scale of it for a model that takes the LR image as it is; one
    tensor for an unconditional recipe."""
    s = config.data.image_size
    if not is_conditional_config(config):
        return torch.empty(batch, s, s, 3, device=device)
    ys = s // config.data.scale if config.model.name == "ncsnpp_KxSR" else s
    return {"x": torch.empty(batch, s, s, 3, device=device), "y": torch.empty(batch, ys, ys, 3, device=device)}


def count_flops(config, batch: int) -> dict:
    """Operations of one forward, by layer kind, from shapes on the meta
    device (the FIR kernels' work as they do it: 2x2 taps an output of the
    upsample, 4x4 of the downsample)."""
    config.model.fused_tail = config.model.fused_block = False
    model = create_model(config, "meta")
    counts = {
        "conv3x3": 0, "conv3x3_gated_tails": 0, "gated_tail_calls": 0,
        "gated_blocks": 0, "gated_block_calls": 0, "conv1x1": 0, "dense": 0, "attention": 0,
        "fir": 0, "fir_upsample2_calls": 0, "fir_downsample2_calls": 0,
    }
    blocks = [m for m in model.modules() if isinstance(m, FusedResblock)]
    tails = {id(m.conv1) for m in blocks}
    # the convs and shortcut a whole-block kernel computes
    whole = [m for m in blocks if not (getattr(m, "up", False) or getattr(m, "down", False))]
    in_blocks = {id(c) for m in whole for c in (m.conv0, m.conv1, m.shortcut) if c is not None}
    in_blocks |= {id(m.shortcut.dense) for m in whole if isinstance(m.shortcut, NIN)}

    def block_gated(shape):
        return fused_block_candidate_policy(shape, shape[-1])

    def conv_hook(mod, args, out):
        flops = 2 * out.numel() * mod.weight.shape[1] * mod.weight.shape[2] * mod.weight.shape[3]
        counts["conv3x3" if isinstance(mod, Conv3x3) else "conv1x1"] += flops
        if id(mod) in in_blocks and block_gated(out.shape):
            counts["gated_blocks"] += flops
        elif id(mod) in tails and fused_tail_candidate_policy(out.shape, out.shape[-1]):
            counts["conv3x3_gated_tails"] += flops
            counts["gated_tail_calls"] += 1

    def dense_hook(mod, args, out):
        weight = mod.weight if isinstance(mod, Dense) else mod.dense.weight
        flops = 2 * out.numel() * weight.shape[1]
        counts["dense"] += flops
        if id(mod) in in_blocks and block_gated(out.shape):
            counts["gated_blocks"] += flops

    def block_hook(mod, args, out):
        counts["gated_block_calls"] += int(mod in whole and block_gated(out.shape))

    def attn_hook(mod, args, out):
        B, H, W, C = out.shape
        counts["attention"] += 2 * 2 * B * (H * W) ** 2 * C  # q.k and w.v

    def fir_stub(name, taps_per_output):
        def fn(x, k=None):
            B, H, W, C = x.shape
            hw = (2 * H, 2 * W) if name == "fir_upsample2" else (H // 2, W // 2)
            out = torch.empty(B, *hw, C, device=x.device, dtype=x.dtype)
            counts["fir"] += 2 * taps_per_output * out.numel()
            counts[f"{name}_calls"] += 1
            return out

        return fn

    for m in model.modules():
        if isinstance(m, (Conv3x3, Conv1x1)):
            m.register_forward_hook(conv_hook)
        elif isinstance(m, (Dense, SplitNIN)):  # SplitNIN computes with F.linear, not through its Dense
            m.register_forward_hook(dense_hook)
        elif isinstance(m, FusedResblock):
            m.register_forward_hook(block_hook)
        elif isinstance(m, (layers.AttnBlock, AttnBlockpp)):
            m.register_forward_hook(attn_hook)
    real = fir.fir_upsample2, fir.fir_downsample2
    fir.fir_upsample2, fir.fir_downsample2 = fir_stub("fir_upsample2", 4), fir_stub("fir_downsample2", 16)
    try:
        with torch.no_grad():
            model(path_inputs(config, batch, "meta"), torch.empty(batch, device="meta"))
    finally:
        fir.fir_upsample2, fir.fir_downsample2 = real
    counts["total"] = sum(counts[k] for k in ("conv3x3", "conv1x1", "dense", "attention", "fir"))
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--count", action="store_true", help="count one forward's operations and stop")
    ap.add_argument("--path", choices=tuple(PATHS), default="block", help="which path to time")
    ap.add_argument("--steps", type=int, default=20, help="sampler steps per timed run")
    ap.add_argument("--pairs", type=int, default=3, help="(on, off) pairs of timed runs")
    args = ap.parse_args()

    new_config = PATHS[args.path]
    config = new_config()
    batch_size = config.eval.batch_size
    counts = count_flops(new_config(), batch_size)
    print(f"one forward at B={batch_size}: " + ", ".join(
        f"{k} {v}" if k.endswith("_calls") else f"{k} {v / 1e9:.3f} GFLOP" for k, v in counts.items()
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
    batch = next(iter_test_batches(config))
    y = torch.from_numpy(batch["y"]).cuda()
    shape = tuple(batch["x"].shape)
    if args.path == "harness":
        model_on, _ = load_model(config, "cuda")
    else:
        model_on = init_model_random(config, seed=config.seed, device="cuda")
    if args.path == "ncsnpp":  # off: the same model with the FIR kernels' plain versions
        model_off, off = model_on, plain_versions
    else:
        config_off = new_config()
        config_off.model.fused_tail = config_off.model.fused_block = False
        model_off, off = create_model(config_off, "cuda"), contextlib.nullcontext
        model_off.load_state_dict(model_on.state_dict())
    compute_dtype = torch.bfloat16 if args.path == "block" else None
    sde, eps = sampler_sde(config)
    scores = {
        fused: get_conditional_score_fn(
            get_score_fn(sde, m, conditional=True, continuous=True, compute_dtype=compute_dtype), "x"
        )
        for fused, m in ((True, model_on), (False, model_off))
    }
    contexts = {True: contextlib.nullcontext, False: off}
    s = config.sampling

    def sampler(p_steps):
        return get_pc_conditional_sampler(
            sde, shape, s.predictor, s.corrector, snr=s.snr, p_steps=p_steps,
            c_steps=s.n_steps_each, denoise=s.noise_removal, eps=eps,
        )

    sample = sampler(args.steps)

    def run(fused):
        torch.cuda.synchronize()
        with contexts[fused]():
            t0 = time.perf_counter()
            sample(torch.Generator(device="cuda").manual_seed(0), scores[fused], y)
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / (2 * args.steps) * 1e3

    run(True), run(False)  # warm-up: cuDNN plans, kernel build
    times = {True: [], False: []}
    for i in range(args.pairs):
        order = (True, False) if i % 2 == 0 else (False, True)
        for fused in order:
            times[fused].append(run(fused))
    label = {
        "block": "fused_block+fused_tail, bfloat16",
        "tail": "fused_tail, float32",
        "ncsnpp": "NCSN++ FIR kernels, float32",
        "harness": "texture64 trained EMA, fused_tail, float32",
    }[args.path]
    for fused in (True, False):
        ts = times[fused]
        print(
            f"{label} {'on' if fused else 'off'}: ms per score evaluation {['%.3f' % t for t in ts]},"
            f" median {statistics.median(ts):.3f}",
            flush=True,
        )

    short = sampler(2)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for fused, top in ((True, 25), (False, 12)):
        torch.cuda.synchronize()
        with contexts[fused](), torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            short(torch.Generator(device="cuda").manual_seed(0), scores[fused], y)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        result = attribute_profile(prof)
        busy_ms = device_ms(result)
        print(
            f"profiled 2 steps (4 score evaluations), {label} {'on' if fused else 'off'}: wall {wall * 1e3:.3f} ms,"
            f" kernels {busy_ms:.3f} ms of device time, busy share {busy_ms / 1e3 / wall:.3f},"
            f" {kernel_launches(result) / 4:.0f} kernel launches per score evaluation; per evaluation by family,"
            " then by kernel:",
            flush=True,
        )
        print("\n".join(per_unit_lines(result, 4, top)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
