"""The C++ host batch path and the prefetch thread (JAX `data/native.py` and
`native/csdt_native.cpp`).

:func:`assemble_batch` turns a list of uint8 HWC images into one float32
[0, 1] NHWC batch, each image flipped horizontally where ``flips`` says and
upsampled by nearest neighbour ``up`` times, in ``csrc/host_batch.cpp``
with the interpreter lock released (ctypes): a table of the 256 quotients
v / 255 (numpy's, so ``backend="native"`` and the plain ``backend="numpy"``
give the same bits) and a thread per 16 MiB of output (:func:`threads_for`).

The library is built with g++ at first use, never at import, into
``_build/libhost_batch-<digest>.so``, the digest a hash of the source and
the flags (as `ops/nvcc.py` names the kernels); a build writes a temporary
file and renames it, so processes that build at once all load a whole
library.  A failed build raises: the numpy version runs only where the
caller asks for it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import queue
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "host_batch.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
BACKENDS = ("native", "numpy")


def source_digest() -> str:
    """Hash of ``csrc/host_batch.cpp`` and the flags."""
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return h.hexdigest()[:12]


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (once per content of the source) and load the host library."""
    path = BUILD_DIR / f"libhost_batch-{source_digest()}.so"
    if not path.exists():
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("no C++ compiler (g++) to build csrc/host_batch.cpp")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)], capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building {SOURCE.name} failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    lib.csdt_assemble_batch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ]
    lib.csdt_assemble_batch.restype = ctypes.c_int
    return lib


BYTES_PER_THREAD = 16 << 20  # the copy is bound by memory: below this a thread costs more than it saves


def threads_for(n_images: int, out_bytes: int) -> int:
    """Threads for a batch: one per ``BYTES_PER_THREAD`` of output, at most
    one per image and one per core."""
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else (os.cpu_count() or 1)
    return max(1, min(cores, n_images, out_bytes // BYTES_PER_THREAD))


def assemble_batch(images: List[np.ndarray], up: int = 1, flips: Optional[np.ndarray] = None,
                   backend: str = "native") -> np.ndarray:
    """uint8 HWC images of one shape -> float32 ``[B, H * up, W * up, C]`` in
    [0, 1]; image ``i`` flipped along W where ``flips[i]``.  A 2-D (H, W)
    image gives a ``[B, H * up, W * up]`` batch.  ``backend="numpy"`` is
    the plain version."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}; one of {BACKENDS}")
    if up < 1:
        raise ValueError(f"up must be >= 1, got {up}")
    if backend == "numpy":
        out = []
        for i, im in enumerate(images):
            x = (im[:, ::-1] if flips is not None and flips[i] else im).astype(np.float32) / 255.0
            out.append(x.repeat(up, axis=0).repeat(up, axis=1) if up > 1 else x)
        return np.stack(out)
    shape = images[0].shape
    for im in images:
        if im.dtype != np.uint8 or im.shape != shape:
            raise TypeError(f"images must be uint8 of one shape; got {im.dtype} {im.shape} beside {shape}")
    if len(shape) not in (2, 3):
        raise ValueError(f"images must be (H, W) or (H, W, C), got {shape}")
    H, W = shape[:2]
    C = shape[2] if len(shape) == 3 else 1
    B = len(images)
    srcs = [np.ascontiguousarray(im) for im in images]  # kept alive across the call
    ptrs = (ctypes.c_void_p * B)(*[s.ctypes.data for s in srcs])
    flip_bytes = None
    if flips is not None:
        flip_bytes = np.ascontiguousarray(np.asarray(flips).astype(bool).astype(np.uint8))
        if flip_bytes.shape != (B,):
            raise ValueError(f"flips must hold one entry per image ({B}), got {flip_bytes.shape}")
    out = np.empty((B, H * up, W * up) + shape[2:], dtype=np.float32)
    rc = load_library().csdt_assemble_batch(
        ptrs, B, H, W, C, up, None if flip_bytes is None else flip_bytes.ctypes.data, out.ctypes.data,
        threads_for(B, out.nbytes),
    )
    if rc != 0:
        raise RuntimeError(f"csdt_assemble_batch returned {rc}")
    return out


class PrefetchIterator:
    """Batches of ``iterator`` made ahead on a background thread, at most
    ``depth`` waiting (JAX `data/native.py:PrefetchIterator`): the host
    builds the next batch while the device runs the step.  An error of the
    iterator is raised again in the consumer.  `close` stops the thread
    (the train iterator never ends by itself)."""

    def __init__(self, iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._sentinel = object()
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()

        def run():
            try:
                for item in iterator:
                    if not self._put(item):
                        return
            except BaseException as e:  # raised again in the consumer
                self._err = e
            finally:
                self._put(self._sentinel)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def close(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._thread.join(timeout)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._sentinel:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
