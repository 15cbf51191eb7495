"""The port's train split (`data/pkl_datasets.py:PKLDataModule`) against the
JAX package's datamodules, exactly.

`General_PKLDataset` on the committed texture160 train split at the
recipe's batch of 16: the first 3 batches of both `train_iterator`s (x, y),
and the flip mask each batch drew, replayed from `np.random.default_rng`
(the permutation of the epoch, then one draw per batch).  The JAX batch
assembler runs with its C++ extension off: the extension scales by 1/255
as a product and differs by one float32 ulp (`tests/test_torch_data.py`).

`LRHR_PKLDataset` has no train split of texture160 in the repo, so its
train batch maker runs on the test pairs, with and without ``upscale_lr``.
"""

import os

import jax  # noqa: F401  (the parity files import both frameworks)
import numpy as np
import pytest
import torch

from conditional_score_diffusion_tpu.data import native as jax_native
from conditional_score_diffusion_tpu.data import pkl_datasets as jax_pkl
from conditional_score_diffusion_tpu_torch.configs import texture160_kxsr_ncsnpp_config, texture160_sr_cmde_config
from conditional_score_diffusion_tpu_torch.data import pkl_datasets
from conditional_score_diffusion_tpu_torch.data.degradations import sr_degrade

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def no_native(monkeypatch):
    monkeypatch.setattr(jax_native, "load_native", lambda: None)


def test_train_batches_are_the_jax_batches(no_native):
    config = texture160_sr_cmde_config()
    config.data.base_dir = os.path.join(REPO, "datasets")
    jdm = jax_pkl.GeneralPKLDataModule(config)
    jdm.setup()
    got_it = pkl_datasets.PKLDataModule(config).train_iterator()
    want_it = jdm.train_iterator()
    images = jdm.images["train"]
    rng = np.random.default_rng(config.seed)
    order = rng.permutation(len(images))
    bs = config.training.batch_size
    for i in range(3):
        got, want = next(got_it), next(want_it)
        idx = order[i * bs : (i + 1) * bs]
        flips = rng.random(bs) < 0.5
        assert 0 < flips.sum() < bs
        x = np.stack([(im[:, ::-1] if f else im).astype(np.float32) / 255.0 for im, f in zip([images[j] for j in idx], flips)])
        assert got.keys() == want.keys() == {"x", "y"}
        for k in ("x", "y"):
            assert got[k].dtype == np.float32 and got[k].shape == (bs, 160, 160, 3)
            assert np.array_equal(got[k], want[k]), (i, k)
        assert np.array_equal(got["x"], x)
        assert np.array_equal(got["y"], sr_degrade(x, config.data.scale))


@pytest.mark.parametrize("upscale_lr", [False, True])
def test_lrhr_train_batch_is_the_jax_batch(no_native, upscale_lr):
    config = texture160_kxsr_ncsnpp_config()
    config.data.base_dir = os.path.join(REPO, "datasets")
    config.data.upscale_lr = upscale_lr
    paths = pkl_datasets.pkl_paths(config, "test")
    pairs = {"lr": pkl_datasets.load_pkl_images(paths["LQ"], 8), "hr": pkl_datasets.load_pkl_images(paths["GT"], 8)}
    jdm = jax_pkl.LRHRPKLDataModule(config)
    jdm.images = {"train": pairs}
    dm = pkl_datasets.PKLDataModule(config)
    dm._images["train"] = pairs
    idx = np.array([5, 0, 3, 7, 1, 2])
    got = dm.make_batch_fn("train")(idx, np.random.default_rng(3))
    want = jdm._make_batch_fn("train")(idx, np.random.default_rng(3))
    assert got["y"].shape[1] == (160 if upscale_lr else 40)
    for k in ("x", "y"):
        assert np.array_equal(got[k], want[k]), k
    flips = np.random.default_rng(3).random(len(idx)) < 0.5
    assert 0 < flips.sum() < len(idx)
    for i, j in enumerate(idx):
        hr = pairs["hr"][j].astype(np.float32) / 255.0
        assert np.array_equal(got["x"][i], hr[:, ::-1] if flips[i] else hr)


def test_eval_phases_are_in_order_and_unflipped():
    config = texture160_sr_cmde_config()
    config.data.base_dir = os.path.join(REPO, "datasets")
    got = next(pkl_datasets.PKLDataModule(config).iterator("test", 4))
    hr = pkl_datasets.load_pkl_images(pkl_datasets.pkl_paths(config, "test")["GT"], 4)
    assert np.array_equal(got["x"], pkl_datasets.assemble_batch(hr))


def test_prefetch_thread_stops_on_close_and_passes_errors_on():
    def endless():
        i = 0
        while True:
            yield i
            i += 1

    it = pkl_datasets.PrefetchIterator(endless(), depth=2)
    assert [next(it), next(it), next(it)] == [0, 1, 2]
    it.close(timeout=5.0)
    assert not it._thread.is_alive()

    def failing():
        yield 1
        raise ValueError("bad batch")

    it = pkl_datasets.PrefetchIterator(failing())
    assert next(it) == 1
    with pytest.raises(ValueError, match="bad batch"):
        next(it)
    it.close(timeout=5.0)
    assert not it._thread.is_alive()
