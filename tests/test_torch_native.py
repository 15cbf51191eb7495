"""The port's C++ host batch path (`data/native.py`, `csrc/host_batch.cpp`).

The C++ batch is bit for bit the port's numpy version and JAX's numpy
fallback (its ``load_native`` patched to None), for ``up`` in {1, 2, 4}
with and without flips, and within one float32 ulp of JAX's C++ path
(which multiplies by 1/255 where numpy divides).  Two processes that build
the library into an empty directory at once both load it.  A build that
fails raises.  `PrefetchIterator` keeps order and raises the iterator's
error in the consumer (JAX `tests/test_native.py`).
"""

import os
import subprocess
import sys
import textwrap

import jax  # noqa: F401  (the parity files import both frameworks)
import numpy as np
import pytest
import torch

from conditional_score_diffusion_tpu.data import native as jax_native
from conditional_score_diffusion_tpu_torch.data import native, pkl_datasets
from conditional_score_diffusion_tpu_torch.data.native import PrefetchIterator, assemble_batch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def images(n=6, h=24, w=20, c=3, seed=0):
    rng = np.random.default_rng(seed)
    ims = [rng.integers(0, 256, (h, w, c), dtype=np.uint8) for _ in range(n)]
    ims[0][:] = np.arange(h * w * c, dtype=np.int64).reshape(h, w, c) % 256  # every level
    return ims


def jax_numpy(ims, up, flips, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(jax_native, "load_native", lambda: None)
        return jax_native.assemble_batch(ims, up=up, flips=flips)


@pytest.mark.parametrize("up", [1, 2, 4])
@pytest.mark.parametrize("flipped", [False, True])
def test_native_equals_numpy_bit_for_bit(up, flipped, monkeypatch):
    ims = images()
    flips = np.array([1, 0, 1, 1, 0, 1], np.uint8) if flipped else None
    got = assemble_batch(ims, up=up, flips=flips)
    plain = assemble_batch(ims, up=up, flips=flips, backend="numpy")
    assert got.shape == (6, 24 * up, 20 * up, 3) and got.dtype == np.float32
    assert got.tobytes() == plain.tobytes()
    assert got.tobytes() == jax_numpy(ims, up, flips, monkeypatch).tobytes()
    jax_cxx = jax_native.assemble_batch(ims, up=up, flips=flips)
    ulps = np.abs(got.view(np.int32).astype(np.int64) - jax_cxx.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1


def test_threads_follow_the_output_size(monkeypatch):
    mib = 1 << 20
    assert native.threads_for(16, 5 * mib) == 1
    assert native.threads_for(128, 40 * mib) == min(2, native.threads_for(10**6, 10**12))
    assert native.threads_for(3, 10**12) <= 3
    ims = images(4, 64, 64)  # several threads on one batch: the same bits
    monkeypatch.setattr(native, "threads_for", lambda n, b: 4)
    got = assemble_batch(ims, up=4, flips=[1, 0, 0, 1])
    assert got.tobytes() == assemble_batch(ims, up=4, flips=[1, 0, 0, 1], backend="numpy").tobytes()


def test_grayscale_and_one_image():
    ims = [np.arange(35, dtype=np.uint8).reshape(5, 7)]
    got = assemble_batch(ims, up=3, flips=[1])
    assert got.shape == (1, 15, 21)
    assert got.tobytes() == assemble_batch(ims, up=3, flips=[1], backend="numpy").tobytes()
    assert got[0, 0, 0] == np.float32(6) / np.float32(255)  # the flip puts the last column first


def test_lrhr_batch_upsamples_through_the_native_path():
    hr, lr = images(4, 32, 32, seed=1), images(4, 8, 8, seed=2)
    flips = np.array([0, 1, 1, 0], np.uint8)
    batch = pkl_datasets.make_lrhr_batch(lr, hr, upscale_lr=True, flips=flips)
    y = assemble_batch(lr, flips=flips, backend="numpy").repeat(4, axis=1).repeat(4, axis=2)
    assert batch["y"].tobytes() == y.tobytes()
    assert batch["x"].tobytes() == assemble_batch(hr, flips=flips, backend="numpy").tobytes()


def test_bad_inputs_raise():
    ims = images(2)
    with pytest.raises(TypeError):
        assemble_batch([ims[0], ims[1][:10]])
    with pytest.raises(TypeError):
        assemble_batch([im.astype(np.float32) for im in ims])
    with pytest.raises(ValueError):
        assemble_batch(ims, flips=[1, 0, 1])
    with pytest.raises(ValueError):
        assemble_batch(ims, backend="fast")


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "host_batch.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="failed"):
            assemble_batch(images(2))
        monkeypatch.setattr(native.shutil, "which", lambda name: None)
        with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
            native.load_library()
    finally:
        native.load_library.cache_clear()
    assert not list((tmp_path / "build").glob("*.so"))


BUILD_AT_ONCE = textwrap.dedent(
    """
    import sys, time
    from pathlib import Path
    import numpy as np
    from conditional_score_diffusion_tpu_torch.data import native
    native.BUILD_DIR = Path(sys.argv[1])
    while time.time() < float(sys.argv[2]):  # both start building together
        time.sleep(0.005)
    ims = [np.full((4, 5, 3), 17 * i, np.uint8) for i in range(3)]
    out = native.assemble_batch(ims, up=2, flips=[0, 1, 0])
    ok = out.tobytes() == native.assemble_batch(ims, up=2, flips=[0, 1, 0], backend="numpy").tobytes()
    print("ok" if ok else "differs", native.load_library()._name)
    """
)


def test_two_processes_building_at_once_both_load(tmp_path):
    import time

    env = dict(os.environ, PYTHONPATH=REPO)
    start = time.time() + 3.0
    procs = [
        subprocess.Popen([sys.executable, "-c", BUILD_AT_ONCE, str(tmp_path), str(start)], cwd=REPO, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(2)
    ]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split()[0] == "ok", out
    assert len({out.split()[1] for out, _ in outs}) == 1
    assert [f.name for f in tmp_path.iterdir()] == [f"libhost_batch-{native.source_digest()}.so"]


def test_prefetch_iterator_order_and_exhaustion():
    it = PrefetchIterator(iter(range(10)), depth=3)
    assert list(it) == list(range(10))


def test_prefetch_iterator_propagates_errors():
    def gen():
        yield 1
        raise RuntimeError("boom")

    it = PrefetchIterator(gen())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        for _ in it:
            pass


def test_prefetch_iterator_is_the_datasets_one():
    assert pkl_datasets.PrefetchIterator is PrefetchIterator
