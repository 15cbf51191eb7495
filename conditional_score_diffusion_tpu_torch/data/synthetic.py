"""The 2-D synthetic datasets, copied from the JAX package's
`data/synthetic.py`: GaussianBubbles (a mixture of ``mixtures`` isotropic
Gaussians of scale 0.2 on the unit circle) and two moons, split
train / val / test by ``data.split``.  Every draw comes from
``np.random.default_rng(config.seed)`` in the JAX order, so the port and
the JAX package give the same data and the same batches bit for bit.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from . import register_datamodule


def gaussian_bubbles(n_samples: int, mixtures: int, rng: np.random.Generator) -> np.ndarray:
    if mixtures == 1:
        centers = np.zeros((1, 2))
    else:
        theta = 2 * np.pi * np.arange(mixtures) / mixtures
        centers = np.stack([np.cos(theta), np.sin(theta)], axis=1)
    idx = rng.integers(0, mixtures, size=n_samples)
    return (centers[idx] + rng.normal(scale=0.2, size=(n_samples, 2))).astype(np.float32)


def two_moons(n_samples: int, noise_scale: float, rng: np.random.Generator) -> np.ndarray:
    """Two interleaving half-circles with Gaussian noise of ``noise_scale``,
    shuffled."""
    n_top = n_samples // 2
    n_bot = n_samples - n_top
    t_top = np.pi * rng.random(n_top)
    t_bot = np.pi * rng.random(n_bot)
    top = np.stack([np.cos(t_top), np.sin(t_top)], axis=1)
    bot = np.stack([1.0 - np.cos(t_bot), -np.sin(t_bot) + 0.5], axis=1)
    pts = np.concatenate([top, bot], axis=0)
    pts += rng.normal(scale=noise_scale, size=pts.shape)
    return pts[rng.permutation(n_samples)].astype(np.float32)


class _ArrayIterator:
    """Infinite shuffled (train) or single-epoch (eval) batch iterator; the
    incomplete last batch of an epoch is dropped."""

    def __init__(self, data: np.ndarray, batch_size: int, shuffle: bool, seed: int, loop: bool):
        self.data = data
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.loop = loop
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            order = self.rng.permutation(len(self.data)) if self.shuffle else np.arange(len(self.data))
            for i in range(0, len(order) - self.batch_size + 1, self.batch_size):
                yield self.data[order[i : i + self.batch_size]]
            if not self.loop:
                return


@register_datamodule(name="Synthetic")
class SyntheticDataModule:
    """``data.dataset_type`` ``GaussianBubbles`` (default) or ``Moons``,
    ``data.data_samples`` points; a batch is a bare ``[B, 2]`` float32
    array."""

    def __init__(self, config):
        self.config = config
        d = config.data
        self.n_samples = d.data_samples
        self.dataset_type = d.get("dataset_type", "GaussianBubbles")
        self.mixtures = d.get("mixtures", 4)
        self.noise_scale = d.get("noise_scale", 0.015)
        self.split = list(d.split)
        self.seed = config.seed

    def setup(self):
        rng = np.random.default_rng(self.seed)
        if self.dataset_type == "Moons":
            data = two_moons(self.n_samples, self.noise_scale, rng)
        else:
            data = gaussian_bubbles(self.n_samples, self.mixtures, rng)
        n = len(data)
        n_train = int(self.split[0] * n)
        n_val = int(self.split[1] * n)
        self.train_data = data[:n_train]
        self.val_data = data[n_train : n_train + n_val]
        self.test_data = data[n_train + n_val :]

    def train_iterator(self, batch_size: Optional[int] = None):
        bs = batch_size or self.config.training.batch_size
        return iter(_ArrayIterator(self.train_data, bs, shuffle=True, seed=self.seed, loop=True))

    def val_iterator(self, batch_size: Optional[int] = None):
        bs = batch_size or self.config.eval.batch_size
        return iter(_ArrayIterator(self.val_data, bs, shuffle=False, seed=self.seed, loop=False))

    def test_iterator(self, batch_size: Optional[int] = None):
        bs = batch_size or self.config.eval.batch_size
        return iter(_ArrayIterator(self.test_data, bs, shuffle=False, seed=self.seed, loop=False))
