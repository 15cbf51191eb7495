"""The port's metrics (`eval/metrics.py`) and `imresize` (`ops/resize.py`)
against the JAX package's on the CPU.

On the committed sample trees of the trained texture64 run (`draw_2`
against `x_gt`, 64 images at 64px, read as the JAX pipeline reads them) and
on random arrays.  JAX casts to float64, which it runs in float32 (x64 is
off); the port runs float64.  Tolerances: 1e-4 relative for SSIM,
consistency and diversity, 1e-3 dB for PSNR; `imresize` 1e-5 of the
largest magnitude (both float32, sums in another order).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from conditional_score_diffusion_tpu.eval import metrics as jax_metrics
from conditional_score_diffusion_tpu.ops.resize import imresize as jax_imresize
from conditional_score_diffusion_tpu_torch.eval import metrics
from conditional_score_diffusion_tpu_torch.ops.resize import imresize

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREES = os.path.join(REPO, "artifacts", "texture64_run", "evaluation", "super-resolution", "texture64", "ours_NDV",
                     "images")


def _tree(name, n=64):
    return np.stack([
        np.asarray(Image.open(os.path.join(TREES, name, f"{i}.png")).convert("RGB"), dtype=np.float32) / 255.0
        for i in range(1, n + 1)
    ])


@pytest.fixture(scope="module")
def committed():
    return _tree("samples/snr_0.150/draw_2"), _tree("x_gt")


@pytest.fixture(scope="module")
def random_pair():
    rng = np.random.RandomState(0)
    gt = rng.rand(3, 32, 32, 3).astype(np.float32)
    return np.clip(gt + 0.05 * rng.randn(*gt.shape), 0, 1).astype(np.float32), gt


def _pair(request, name):
    return request.getfixturevalue(name)


def _rel(got, want):
    return abs(got - want) / abs(want)


@pytest.mark.parametrize("data", ["committed", "random_pair"])
def test_psnr_ssim_match_jax(request, data):
    s, x = _pair(request, data)
    got = metrics.psnr(torch.from_numpy(s), torch.from_numpy(x)).numpy()
    want = np.asarray(jax_metrics.psnr(jnp.asarray(s), jnp.asarray(x)))
    assert np.abs(got - want).max() <= 1e-3
    assert abs(metrics.mean_psnr(s, x) - jax_metrics.mean_psnr(jnp.asarray(s), jnp.asarray(x))) <= 1e-3
    got = metrics.ssim(torch.from_numpy(s), torch.from_numpy(x)).numpy()
    want = np.asarray(jax_metrics.ssim(jnp.asarray(s), jnp.asarray(x)))
    assert np.all(np.abs(got - want) <= 1e-4 * np.abs(want))
    assert _rel(metrics.mean_ssim(s, x), jax_metrics.mean_ssim(jnp.asarray(s), jnp.asarray(x))) <= 1e-4


@pytest.mark.parametrize("data", ["committed", "random_pair"])
def test_sr_consistency_matches_jax(request, data):
    s, x = _pair(request, data)
    got = metrics.get_consistency_fn("super-resolution")(torch.from_numpy(s), torch.from_numpy(x), 4)
    want = jax_metrics.get_consistency_fn("super-resolution")(jnp.asarray(s), jnp.asarray(x), 4)
    assert abs(got - want) <= 1e-3


def test_inpainting_consistency_matches_jax(random_pair):
    s, x = random_pair
    mask = np.zeros(x.shape[:3] + (1,), np.float32)
    mask[:, 8:20, 4:16] = 1.0
    got = metrics.get_consistency_fn("inpainting")(torch.from_numpy(s), torch.from_numpy(x), torch.from_numpy(mask))
    want = jax_metrics.get_consistency_fn("inpainting")(jnp.asarray(s), jnp.asarray(x), jnp.asarray(mask))
    assert abs(got - want) <= 1e-3


def test_diversity_matches_jax(committed):
    draws = np.stack([committed[0], _tree("samples/snr_0.150/draw_3"), _tree("samples/snr_0.150/draw_4")]) * 255.0
    got = metrics.diversity(torch.from_numpy(draws))
    want = jax_metrics.diversity(jnp.asarray(draws))
    assert _rel(got, want) <= 1e-4
    rng = np.random.RandomState(1)
    draws = rng.rand(2, 3, 8, 8, 3).astype(np.float32)
    assert _rel(metrics.diversity(draws), jax_metrics.diversity(jnp.asarray(draws))) <= 1e-4


def test_unknown_task_raises():
    with pytest.raises(NotImplementedError):
        metrics.get_consistency_fn("colorization")


@pytest.mark.parametrize("shape,kw", [
    ((2, 64, 64, 3), dict(scale=0.25)),
    ((2, 20, 30, 3), dict(scale=0.5)),
    ((1, 16, 16, 6), dict(scale=2.0)),
    ((9, 12, 3), dict(out_shape=(5, 7))),
    ((1, 16, 16, 3), dict(scale=0.25, antialias=False)),
])
def test_imresize_matches_jax(shape, kw):
    img = np.random.RandomState(len(shape)).rand(*shape).astype(np.float32)
    got = imresize(torch.from_numpy(img), **kw)
    want = np.asarray(jax_imresize(jnp.asarray(img), **kw))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
