"""The port's copies of the host data functions against the JAX package's,
on the texture160 test split, exactly.

The JAX batch assembler has two paths: a C++ extension, which scales by
1/255 as a product, and a numpy fallback, which divides by 255; they differ
by one float32 ulp.  The port copies the numpy path, so the exact
comparisons run the JAX assembler with its extension switched off, and the
extension's path is held to one ulp.
"""

import os

import jax  # noqa: F401  (the parity files import both frameworks)
import numpy as np
import pytest
import torch

from conditional_score_diffusion_tpu.data import degradations as jax_deg
from conditional_score_diffusion_tpu.data import native as jax_native
from conditional_score_diffusion_tpu.data import pkl_datasets as jax_pkl
from conditional_score_diffusion_tpu_torch.configs import texture160_sr_cmde_config
from conditional_score_diffusion_tpu_torch.data import degradations, pkl_datasets

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_numpy_assemble_batch(images, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(jax_native, "load_native", lambda: None)
        return jax_native.assemble_batch(images)


@pytest.fixture(scope="module")
def config():
    c = texture160_sr_cmde_config()
    c.data.base_dir = os.path.join(REPO, "datasets")
    return c


def test_load_pkl_images_matches_jax(config):
    path = pkl_datasets.pkl_paths(config, "test")["GT"]
    got = pkl_datasets.load_pkl_images(path, n_max=3)
    want = jax_pkl.load_pkl_images(path, n_max=3)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.uint8 and g.shape == (160, 160, 3)
        assert np.array_equal(g, w)


@pytest.mark.parametrize("scale", [8, 4])
def test_sr_degrade_matches_jax(config, scale, monkeypatch):
    path = pkl_datasets.pkl_paths(config, "test")["GT"]
    images = pkl_datasets.load_pkl_images(path, n_max=1)
    x = pkl_datasets.assemble_batch(images)
    assert np.array_equal(x, jax_numpy_assemble_batch(images, monkeypatch))
    np.testing.assert_allclose(x, jax_native.assemble_batch(images), rtol=1.2e-7, atol=0)
    got = degradations.sr_degrade(x, scale)
    assert got.shape == x.shape and got.dtype == np.float32
    assert np.array_equal(got, jax_deg.sr_degrade(x, scale))


def test_first_test_batch_is_the_jax_batch(config, monkeypatch):
    got = next(pkl_datasets.iter_test_batches(config, batch_size=2))
    images = jax_pkl.load_pkl_images(pkl_datasets.pkl_paths(config, "test")["GT"], n_max=2)
    x = jax_numpy_assemble_batch(images, monkeypatch)
    assert np.array_equal(got["x"], x)
    assert np.array_equal(got["y"], jax_deg.sr_degrade(x, 8))
