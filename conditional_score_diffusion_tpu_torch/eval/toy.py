"""The sample metrics of the 2-D GaussianBubbles toy, copied from the repo's
`scripts/head_to_head.py` (`make_data`, `sample_metrics`): how much of the
samples' mass each of the 4 modes holds against 1/4, the spread about the
nearest centre, and the energy distance to ground-truth draws.  And the
toy's end-to-end check: 4,000 PC samples from a trained recipe's EMA.
"""

from __future__ import annotations

import numpy as np
import torch

MIXTURES = 4
MODE_SIGMA = 0.2
GT_SEED, N_SAMPLES, SAMPLE_STEPS = 999, 4000, 500


def make_data(seed: int, n: int) -> np.ndarray:
    """``n`` draws of the 4 bubbles on the unit circle (sigma 0.2)."""
    rng = np.random.default_rng(seed)
    theta = 2 * np.pi * np.arange(MIXTURES) / MIXTURES
    centers = np.stack([np.cos(theta), np.sin(theta)], axis=1)
    idx = rng.integers(0, MIXTURES, size=n)
    return (centers[idx] + MODE_SIGMA * rng.standard_normal((n, 2))).astype(np.float32)


def sample_metrics(samples: np.ndarray, gt: np.ndarray) -> dict:
    """``mode_mass`` (each mode's share), ``mode_mass_maxdev`` (its largest
    distance from 1/4), ``per_mode_std`` and ``energy_distance_vs_gt``
    (against ``gt``, both cut to 2,000 points)."""
    k = MIXTURES
    theta = 2 * np.pi * np.arange(k) / k
    centers = np.stack([np.cos(theta), np.sin(theta)], axis=1)
    d = np.linalg.norm(samples[:, None, :] - centers[None], axis=-1)
    assign = d.argmin(1)
    mass = np.bincount(assign, minlength=k) / len(samples)
    resid = samples - centers[assign]
    per_mode_std = float(np.sqrt(np.mean(resid**2)))

    a = samples[:2000]
    b = gt[:2000]

    def _mean_pdist(u, v):
        return float(np.mean(np.linalg.norm(u[:, None] - v[None], axis=-1)))

    e = 2 * _mean_pdist(a, b) - _mean_pdist(a, a) - _mean_pdist(b, b)
    return {
        "mode_mass": [float(m) for m in mass],
        "mode_mass_maxdev": float(np.abs(mass - 1 / k).max()),
        "per_mode_std": per_mode_std,
        "energy_distance_vs_gt": float(e),
    }


def sample_toy(config, model, seed: int, n: int = N_SAMPLES, p_steps: int = SAMPLE_STEPS):
    """``n`` samples of the recipe's PC sampler (``p_steps`` steps) from
    ``model`` (the EMA weights), drawn from a generator on the model's
    device seeded with ``seed``, and their metrics against
    ``make_data(999, n)``."""
    from ..training.tasks import create_task

    device = next(model.parameters()).device
    task = create_task(config, model)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        samples, _ = task.sampling_fn((n, 2), p_steps=p_steps)(gen, model)
    samples = samples.float().cpu().numpy()
    return samples, sample_metrics(samples, make_data(GT_SEED, n))
