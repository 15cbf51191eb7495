"""Device-time attribution of `torch.profiler` Chrome traces (JAX
`profiling/xplane.py`, which reads XSpace protos).

`torch.profiler` writes its timeline with ``export_chrome_trace``: the
trainer's ``CSDT_PROFILE_DIR`` window (`training/trainer.py`),
`profile_sampler.py` and `profile_train_step.py` (:func:`attribute_profile`
exports a live profile).  The JSON holds ``traceEvents``; the device's are
complete events (``"ph": "X"``) with ``"cat"`` ``kernel``, ``gpu_memcpy``
or ``gpu_memset`` and float microsecond ``ts`` / ``dur``, on a device and a
stream (``args``).  Host events (CPU ops, the CUDA runtime, Python
functions), annotations and flow events (``ac2g``) are not device time and
are not read.  A trace of a CPU-only run has no device event: its device
time is 0.

Kernels are the device time (``total_ms``), each classified into a family
by its name (:func:`classify`; the port's own kernels of ``csrc/`` by
their ``__global__`` names first); copies and fills (``gpu_memcpy``,
``gpu_memset``) are kept apart as ``async_overlapped_ms`` /
``top_async_ops``, as JAX keeps its async copy line apart.  Durations are
summed in integer picoseconds, so sums are exact.

CLI: ``python -m conditional_score_diffusion_tpu_torch.profiling
<trace.json or dir> [--top N] [--json]``.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

KERNEL_CATS = ("kernel",)
ASYNC_CATS = ("gpu_memcpy", "gpu_memset")

#: (family, substrings of the lower-cased kernel name); the first match wins.
FAMILY_RULES: List[Tuple[str, Tuple[str, ...]]] = [
    # the port's kernels (csrc/): the 3x3 main loop of kernels 1-5, the
    # GroupNorm+SiLU pass of kernels 1-3, the FIR resamplers, bias + act
    ("conv3x3_gemm", ("conv3x3_gemm",)),
    ("gn_silu_act", ("gn_silu_act",)),
    ("fir_up2_kernel", ("fir_up2_kernel",)),
    ("fir_down2_kernel", ("fir_down2_kernel",)),
    ("bias_act", ("bias_act_",)),
    ("collective (NCCL)", ("nccl",)),  # before "reduce": ncclDevKernel_AllReduce_*
    # layout transforms and casts before the library rules, whose names they share
    ("copy/cast", ("direct_copy", "copy_kernel", "nchwtonhwc", "nhwctonchw", "transpose", "catarraybatchedcopy")),
    # cuDNN's FFT convolution runs cuFFT passes (region_transform, DSE::*_fft), complex GEMMs (cf32)
    # and complex pointwise products
    ("convolution (cuDNN)", ("conv", "fft", "fprop", "dgrad", "wgrad", "cudnn", "winograd", "implicit_gemm",
                             "flip_filter", "region_transform", "gemm_cf32", "pointwise_mult_and_sum_complex")),
    ("gemm (cuBLAS)", ("gemm", "gemv", "cutlass", "cublas", "xmma", "matmul", "nvjet")),
    ("rng", ("distribution", "philox", "randperm")),  # before "norm": torch.randn's kernels say "normal"
    ("reduction/norm", ("reduce", "norm", "softmax", "welford", "scan")),
    ("elementwise", ("elementwise", "multi_tensor_apply", "fill", "index", "where", "upsample")),
]
ASYNC_FAMILY = "memcpy/memset"


def classify(name: str) -> str:
    """The family of a kernel name (``other`` where no rule matches)."""
    n = name.lower()
    for family, keys in FAMILY_RULES:
        if any(k in n for k in keys):
            return family
    return "other"


def find_trace_files(trace: str) -> List[str]:
    """``trace`` itself if it is a file, else every ``*.json`` /
    ``*.json.gz`` under the directory."""
    if os.path.isfile(trace):
        return [trace]
    found = glob.glob(os.path.join(trace, "**", "*.json"), recursive=True)
    found += glob.glob(os.path.join(trace, "**", "*.json.gz"), recursive=True)
    return sorted(found)


def parse_trace(path: str) -> List[dict]:
    """The ``traceEvents`` of one Chrome-trace file (``.json`` or ``.json.gz``)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _picoseconds(us) -> int:
    return int(round(float(us) * 1e6))


def _is_device(ev: dict, cats) -> bool:
    return ev.get("ph") == "X" and ev.get("cat") in cats


def device_streams(events: List[dict]) -> List[str]:
    """``device <d> stream <s>`` of every device event, sorted."""
    streams = set()
    for ev in events:
        if _is_device(ev, KERNEL_CATS + ASYNC_CATS):
            args = ev.get("args", {})
            streams.add(f"device {args.get('device', ev.get('pid'))} stream {args.get('stream', ev.get('tid'))}")
    return sorted(streams)


def device_op_table(events: List[dict], async_ops: bool = False) -> List[dict]:
    """Device time by name: kernels, or with ``async_ops`` the copies and
    fills.  Rows ``{name, family, occurrences, total_ps, avg_ps}``, longest
    first."""
    cats = ASYNC_CATS if async_ops else KERNEL_CATS
    agg: Dict[str, List[int]] = collections.defaultdict(lambda: [0, 0])
    for ev in events:
        if _is_device(ev, cats):
            row = agg[ev.get("name", "")]
            row[0] += _picoseconds(ev.get("dur", 0))
            row[1] += 1
    rows = [
        {"name": name, "family": ASYNC_FAMILY if async_ops else classify(name), "occurrences": occ,
         "total_ps": tot, "avg_ps": tot // max(occ, 1)}
        for name, (tot, occ) in agg.items()
    ]
    rows.sort(key=lambda r: (-r["total_ps"], r["name"]))
    return rows


def attribute(trace: str) -> dict:
    """Attribution of every trace file of ``trace`` (a file or a directory):
    ``{"files", "planes" (the device streams), "total_ms" (kernels),
    "async_overlapped_ms" (copies and fills), "families": {family: {"ms",
    "share", "occurrences"}}, "top_ops" (25 kernels), "top_async_ops"
    (10)}``, JAX `profiling.xplane.attribute`'s keys."""
    files = find_trace_files(trace)
    events: List[dict] = []
    for f in files:
        events.extend(parse_trace(f))
    table = device_op_table(events)
    async_table = device_op_table(events, async_ops=True)
    total_ps = sum(r["total_ps"] for r in table)
    fams: Dict[str, List[int]] = collections.defaultdict(lambda: [0, 0])
    for r in table:
        fams[r["family"]][0] += r["total_ps"]
        fams[r["family"]][1] += r["occurrences"]
    return {
        "files": files,
        "planes": device_streams(events),
        "total_ms": total_ps / 1e9,
        "async_overlapped_ms": sum(r["total_ps"] for r in async_table) / 1e9,
        "families": {
            k: {"ms": ps / 1e9, "share": ps / total_ps if total_ps else 0.0, "occurrences": n}
            for k, (ps, n) in sorted(fams.items(), key=lambda kv: (-kv[1][0], kv[0]))
        },
        "top_ops": table[:25],
        "top_async_ops": async_table[:10],
    }


def attribute_profile(prof) -> dict:
    """:func:`attribute` of a finished ``torch.profiler.profile``, through
    its Chrome trace written to a temporary file (``files`` is empty)."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        result = attribute(path)
    result["files"] = []
    return result


def device_ms(result: dict) -> float:
    """Kernels plus copies and fills: every device event's time."""
    return result["total_ms"] + result["async_overlapped_ms"]


def kernel_launches(result: dict) -> int:
    """The kernels of an attribution (copies and fills not counted)."""
    return sum(f["occurrences"] for f in result["families"].values())


def per_unit_lines(result: dict, per: float = 1, top: int = 15) -> List[str]:
    """The families, then the ``top`` kernels, of an attribution: ms and
    launches divided by ``per`` (the steps or evaluations of the window)."""
    lines = [f"  {d['ms'] / per:10.3f} ms {d['occurrences'] / per:8.1f}x  {family} ({d['share']:.3f})"
             for family, d in result["families"].items()]
    return lines + [f"  {r['total_ps'] / 1e9 / per:10.3f} ms {r['occurrences'] / per:8.1f}x  {r['name'][:110]}"
                    for r in result["top_ops"][:top]]


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="Attribute device time in a torch.profiler Chrome trace")
    p.add_argument("trace", help="a trace .json (.json.gz) or a directory of them")
    p.add_argument("--top", type=int, default=15, help="top-N kernels to print")
    p.add_argument("--json", action="store_true", help="print the whole attribution as JSON")
    args = p.parse_args(argv)

    result = attribute(args.trace)
    if args.json:
        print(json.dumps(result, indent=2))
        return
    print(f"trace files: {len(result['files'])}  device streams: {result['planes']}")
    print(f"kernel time: {result['total_ms']:.3f} ms  (+{result['async_overlapped_ms']:.3f} ms memcpy/memset)")
    print(f"{'family':<22}{'ms':>10}{'share':>8}{'n':>8}")
    for fam, d in result["families"].items():
        print(f"{fam:<22}{d['ms']:>10.3f}{d['share']:>8.1%}{d['occurrences']:>8}")
    print()
    print(f"{'kernel':<50}{'n':>6}{'total ms':>10}{'avg us':>9}")
    for r in result["top_ops"][: args.top]:
        print(f"{r['name'][:49]:<50}{r['occurrences']:>6}{r['total_ps'] / 1e9:>10.3f}{r['avg_ps'] / 1e6:>9.1f}")
