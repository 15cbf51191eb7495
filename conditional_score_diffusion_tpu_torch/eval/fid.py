"""FID and joint FID, copied from the JAX package's `eval/fid.py`: the
statistics of Inception activations in float64 and the Frechet distance
between the two Gaussians (scipy's `sqrtm`; where its result is not
finite, again with ``eps`` added to both covariances' diagonals; the real
part).  Joint FID compares ``(y, x)`` against ``(y, sample)`` with the
activations concatenated.

One change: where neither set holds more images than features, as in
every test split of the repo (2,048 features; 4,096 for joint FID),
:func:`fid_from_activations` takes tr sqrtm(sigma1 sigma2) as the sum of
the singular values of ``X1 X2^T`` (X the centred activations over
sqrt(N - 1)), which equals it exactly: the nonzero eigenvalues of
``X1^T X1 X2^T X2`` are those of ``(X1 X2^T)(X1 X2^T)^T``.  scipy's
`sqrtm` of that singular 4,096 x 4,096 product takes ~145 s on 8 cores
and leaves ~1e-6 of the distance in rounding of its zero eigenvalues;
this takes milliseconds."""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import linalg


def activation_statistics(acts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(mu, sigma)`` of ``[N, D]`` activations, in float64."""
    acts = np.asarray(acts, dtype=np.float64)
    return acts.mean(axis=0), np.cov(acts, rowvar=False)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """The Frechet distance between N(mu1, sigma1) and N(mu2, sigma2)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean, _ = linalg.sqrtm(sigma1.dot(sigma2), disp=False)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def fid_from_activations(acts1: np.ndarray, acts2: np.ndarray) -> float:
    mu1, s1 = activation_statistics(acts1)
    mu2, s2 = activation_statistics(acts2)
    if max(len(acts1), len(acts2)) > np.shape(acts1)[1]:
        return frechet_distance(mu1, s1, mu2, s2)
    x1, x2 = (_centred(a) for a in (acts1, acts2))
    trace_covmean = np.linalg.svd(x1 @ x2.T, compute_uv=False).sum()
    diff = mu1 - mu2
    return float(diff.dot(diff) + np.trace(s1) + np.trace(s2) - 2 * trace_covmean)


def _centred(acts: np.ndarray) -> np.ndarray:
    """``acts`` less their mean, over sqrt(N - 1): ``X^T X`` is their covariance."""
    acts = np.asarray(acts, dtype=np.float64)
    return (acts - acts.mean(axis=0)) / np.sqrt(len(acts) - 1)


def joint_fid_from_activations(acts_y: np.ndarray, acts_x: np.ndarray, acts_sample: np.ndarray) -> float:
    """FID of ``concat(acts_y, acts_x)`` against ``concat(acts_y, acts_sample)``."""
    return fid_from_activations(np.concatenate([acts_y, acts_x], axis=1), np.concatenate([acts_y, acts_sample], axis=1))
