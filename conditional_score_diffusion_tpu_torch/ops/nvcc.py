"""Build a CUDA source of ``csrc/`` with nvcc and load it with ctypes.

Every kernel of the port is a ``.cu`` file with a plain C interface.  It is
compiled for sm_90a into a shared library under ``_build/`` at first use
(never at import: the CPU tests import every module), named by a hash of
the source, every shared header ``csrc/*.cuh`` and the flags (:func:`source_digest`),
so a changed source or header builds anew, and loaded with `ctypes`.  The
caller sets the C functions' argument types.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class KernelLibrary(NamedTuple):
    lib: ctypes.CDLL
    path: str
    build_seconds: float  # 0.0 when an earlier build of the same source was loaded
    build_log: str


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the port's kernels need the CUDA toolkit")
    return path


def source_digest(name: str, csrc: Path = CSRC) -> str:
    """Hash of ``<csrc>/<name>.cu``, every ``<csrc>/*.cuh`` it may include
    (by name and content, in name order) and the nvcc flags."""
    h = hashlib.sha1((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


@functools.cache
def build(name: str) -> KernelLibrary:
    """Build ``csrc/<name>.cu`` (once per content of it and the headers) and load it."""
    source = CSRC / f"{name}.cu"
    digest = source_digest(name)
    path = BUILD_DIR / f"lib{name}-{digest}.so"
    seconds, log = 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
        os.replace(tmp, path)
    return KernelLibrary(ctypes.CDLL(str(path)), str(path), seconds, log)
