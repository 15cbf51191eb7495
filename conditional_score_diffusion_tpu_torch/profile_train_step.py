"""Where a train step's time goes on the card.

    python -m conditional_score_diffusion_tpu_torch.profile_train_step [--steps 4] [--pairs 2]

The flagship trainer path (`configs.texture160_sr_cmde_conv3x3`: full width,
float32 with TF32 off, batch 16, one batch of the texture160 train split,
the DDPM init from the recipe's seed), with kernel 4 on (``conv_dispatch =
'conv3x3_kernel'``) and off (``'none'``: cuDNN): a warm-up step each, then
``--steps`` steps timed by the host clock after a synchronize, on and off in
turns (on, off, off, on, ...); then one profiled window of 2 steps each,
whose kernels are listed by device time with the device's busy share.  The
card's name and power limit are printed first.

A profiled window is split by kernel family with `profiling.attribute`;
the plain FIR's device time in a step (:func:`recording_upfirdn`,
:func:`plain_fir_ms`: every `ops/upfirdn.py:upfirdn2d` call of one step,
run again forward and, where a gradient flows through it, backward, its
kernels' durations summed by :func:`kernel_ms`) is what `chip_smoke.py`
reports for the NCSN++ DF2K direct 4x trainer.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from .configs import texture160_sr_cmde_conv3x3_config
from .data.pkl_datasets import PKLDataModule
from .models import create_model
from .ops import upfirdn
from .profiling import attribute_profile, device_ms, kernel_launches, per_unit_lines
from .training.state import create_train_state
from .training.steps import make_train_step, seeded
from .training.trainer import to_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def recording_upfirdn():
    """Count every `ops/upfirdn.py:upfirdn2d` call made in the block (the
    plain FIR: every resampling that does not reach `ops/fir.py`'s
    kernels) by ``(shape, dtype, kernel, up, down, pad, gradient flows)``."""
    calls = collections.Counter()
    real = upfirdn.upfirdn2d

    def spy(x, kernel, up=1, down=1, pad=(0, 0)):
        k = np.asarray(kernel, np.float32)
        grad = torch.is_grad_enabled() and x.requires_grad
        calls[(tuple(x.shape), x.dtype, tuple(k.ravel().tolist()), k.shape, up, down, tuple(pad), grad)] += 1
        return real(x, kernel, up, down, pad)

    upfirdn.upfirdn2d = spy
    try:
        yield calls
    finally:
        upfirdn.upfirdn2d = real


def kernel_ms(fn, warmup: int = 1) -> float:
    """Device time of one call of ``fn``: the summed durations of the
    kernels, copies and fills it launches (`torch.profiler`, attributed by
    `profiling.attribute_profile`); idle time between them does not count."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return device_ms(attribute_profile(prof))



def plain_fir_ms(calls, timer, device) -> float:
    """``timer(fn)`` of one pass over the ``calls`` of
    :func:`recording_upfirdn`: each distinct call, on random inputs, as
    many times as it was made, its forward and, where a gradient flowed,
    ``torch.autograd.grad`` of it (chip_smoke: :func:`kernel_ms`)."""
    fns = []
    for (shape, dtype, flat, kshape, up, down, pad, grad), n in calls.items():
        k = np.asarray(flat, np.float32).reshape(kshape)
        x = torch.randn(shape, device=device, dtype=dtype, requires_grad=grad)
        if grad:
            g = torch.randn_like(upfirdn.upfirdn2d(x, k, up, down, pad))

            def fn(x=x, k=k, up=up, down=down, pad=pad, g=g):
                torch.autograd.grad(upfirdn.upfirdn2d(x, k, up, down, pad), x, g)
        else:

            def fn(x=x, k=k, up=up, down=down, pad=pad):
                upfirdn.upfirdn2d(x, k, up, down, pad)

        fns += [fn] * n

    def every_call():
        for fn in fns:
            fn()

    return timer(every_call)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=4, help="train steps per timed run")
    ap.add_argument("--pairs", type=int, default=2, help="(on, off) pairs of timed runs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_step: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"card: {smi}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")

    configs = {"on": texture160_sr_cmde_conv3x3_config(), "off": texture160_sr_cmde_conv3x3_config()}
    configs["off"].model.conv_dispatch = "none"
    for c in configs.values():
        c.data.base_dir = os.path.join(REPO, "datasets")
    with seeded(configs["on"].seed, device):
        models = {"on": create_model(configs["on"], device)}
    models["off"] = create_model(configs["off"], device)
    models["off"].load_state_dict(models["on"].state_dict())
    states = {k: create_train_state(configs[k], m.train()) for k, m in models.items()}
    steps = {k: make_train_step(configs[k], m) for k, m in models.items()}
    batch = to_device(next(PKLDataModule(configs["on"]).train_iterator()), device)

    def run(key, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            steps[key](states[key], batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    run("on", 1), run("off", 1)  # warm-up: cuDNN plans, the kernel's build
    times = {"on": [], "off": []}
    for i in range(args.pairs):
        for key in (("on", "off") if i % 2 == 0 else ("off", "on")):
            times[key].append(run(key, args.steps))
    for key in ("on", "off"):
        print(
            f"kernel 4 {key}: ms per train step {['%.3f' % t for t in times[key]]},"
            f" median {statistics.median(times[key]):.3f}",
            flush=True,
        )
    print(f"peak memory of both models and their states: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for key in ("on", "off"):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            wall = run(key, 2) * 2 / 1e3
        result = attribute_profile(prof)
        busy_ms = device_ms(result)
        print(
            f"profiled 2 train steps, kernel 4 {key}: wall {wall * 1e3:.3f} ms, kernels {busy_ms:.3f} ms"
            f" of device time, busy share {busy_ms / 1e3 / wall:.3f},"
            f" {kernel_launches(result) / 2:.0f} kernel launches per step; per step by family, then by kernel:",
            flush=True,
        )
        print("\n".join(per_unit_lines(result, 2, 25)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
