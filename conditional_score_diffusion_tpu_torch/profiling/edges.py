"""Whether a `torch.profiler` window loses kernels at its start, with and
without a host margin between the window's edges and the traced work (the
trainer's ``PROFILE_MARGIN_S``, `training/trainer.py`), and with and
without a warm-up (the trainer's: CUPTI's collection prepared one step
before the window starts).

    python -m conditional_score_diffusion_tpu_torch.profiling.edges [--windows 100] [--kernels 64]
        [--rounds 1] [--idle 0]

Each window starts on an idle card: ``start()`` (or, warmed up,
``prepare_trace()``, ``--kernels`` throwaway kernels, a synchronize,
``start_trace()``), the margin, ``--kernels`` small kernels launched back
to back, a synchronize, the margin, ``stop()``; the kernels in the profile
are counted against those launched.  The four kinds of window (margin 0 or
``PROFILE_MARGIN_S``, cold or warmed up) alternate, in ``--rounds`` rounds
``--idle`` seconds apart.  Prints one JSON line: for each round and kind
the windows, those that lost a kernel, the kernels lost, and the start of
the first kernel seen after the window's start (microseconds: least,
median).
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch


def window(x: torch.Tensor, kernels: int, margin_s: float, warm: bool):
    """One profiled window; ``(kernels seen, first kernel's start in us
    after the window's)``."""
    torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    if warm:
        prof.prepare_trace()
        for _ in range(kernels):
            x.add_(1.0)
        torch.cuda.synchronize()
        prof.start_trace()
    else:
        prof.start()
    time.sleep(margin_s)
    for _ in range(kernels):
        x.add_(1.0)
    torch.cuda.synchronize()
    time.sleep(margin_s)
    prof.stop()
    seen = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(seen), min((e.time_range.start for e in seen), default=float("nan"))


def main(argv=None) -> dict:
    from ..training.trainer import PROFILE_MARGIN_S

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--windows", type=int, default=100, help="windows for each margin")
    parser.add_argument("--kernels", type=int, default=64, help="kernels launched in each window")
    parser.add_argument("--rounds", type=int, default=1, help="rounds of windows")
    parser.add_argument("--idle", type=float, default=0.0, help="seconds between rounds")
    args = parser.parse_args(argv)
    x = torch.zeros(1 << 20, device="cuda")
    window(x, args.kernels, 0.0, False)  # the profiler's first start, untimed
    out = {"device": torch.cuda.get_device_name(0), "kernels_per_window": args.kernels, "margins": []}
    t0 = time.perf_counter()
    for r in range(args.rounds):
        if r:
            time.sleep(args.idle)
        runs = {(m, w): [] for w in (False, True) for m in (0.0, PROFILE_MARGIN_S)}
        age = time.perf_counter() - t0
        for _ in range(args.windows):
            for margin, warm in runs:
                runs[margin, warm].append(window(x, args.kernels, margin, warm))
        for (margin, warm), seen in runs.items():
            starts = [s for _, s in seen if s == s]
            out["margins"].append(dict(
                round=r, age_s=age, margin_s=margin, warm_up=warm, windows=len(seen),
                windows_short=sum(n < args.kernels for n, _ in seen),
                kernels_lost=sum(args.kernels - n for n, _ in seen),
                windows_over=sum(n > args.kernels for n, _ in seen),
                first_kernel_us_min=min(starts, default=None),
                first_kernel_us_median=statistics.median(starts) if starts else None))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
