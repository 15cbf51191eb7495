"""Colorization by gray-channel decoupling (JAX `sampling/controllable.py`).

An orthonormal 3x3 basis whose first row is the gray direction
(1, 1, 1) / sqrt(3) decouples RGB into (gray, chroma1, chroma2); the PC
sampler runs with the gray channel of the decoupled state projected onto
the noised known gray image after the corrector and after the predictor of
each of ``sde.N`` steps, and couples back to RGB.  Draws come from one noise
source in the JAX order of use: the prior, then for each step the
corrector's, the projection's, the predictor's and the projection's again.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..sde import batch_mul
from .correctors import get_corrector
from .pc import _as_noise, _stacked
from .predictors import get_predictor


def _gray_basis(device=None) -> torch.Tensor:
    """Orthonormal 3x3 with first row (1, 1, 1) / sqrt(3) (the gray direction)."""
    M = np.zeros((3, 3))
    M[0] = 1.0 / np.sqrt(3.0)
    M[1] = np.array([1.0, -1.0, 0.0]) / np.sqrt(2.0)
    M[2] = np.array([1.0, 1.0, -2.0]) / np.sqrt(6.0)
    return torch.tensor(M, dtype=torch.float32, device=device)


def decouple(x: torch.Tensor) -> torch.Tensor:
    """RGB (last axis) -> (gray, chroma1, chroma2)."""
    return torch.einsum("...c,kc->...k", x, _gray_basis(x.device))


def couple(z: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...k,kc->...c", z, _gray_basis(z.device))


def _with_gray(z: torch.Tensor, gray: torch.Tensor) -> torch.Tensor:
    """``z`` with its first (gray) channel taken from ``gray``."""
    return torch.cat([gray[..., :1], z[..., 1:]], dim=-1)


def get_pc_colorizer(
    sde,
    predictor: str,
    corrector: str,
    snr: float,
    n_steps: int = 1,
    probability_flow: bool = False,
    denoise: bool = True,
    eps: float = 1e-5,
) -> Callable:
    """Returns ``colorizer(noise, score_fn, gray_image, show_evolution=False)
    -> (rgb, info)``.

    ``gray_image`` is an RGB image whose channels all hold the known gray
    value (`data.degradations.grayscale` broadcast to 3 channels).  With
    ``denoise`` the result is the predictor's mean with the clean gray
    channel set in.
    """
    predictor_fn = get_predictor(predictor)
    corrector_fn = get_corrector(corrector)

    def project(noise, x, gray, vec_t):
        """Constrain the gray channel of the decoupled state."""
        mean, std = sde.marginal_prob(gray, vec_t)
        perturbed_gray = mean + batch_mul(std, noise(gray.shape))
        return couple(_with_gray(decouple(x), decouple(perturbed_gray)))

    def colorizer(noise, score_fn, gray_image, show_evolution: bool = False):
        noise = _as_noise(noise)
        B = gray_image.shape[0]
        clean_gray = decouple(gray_image)
        x = sde.prior_sampling(noise, tuple(gray_image.shape)).float()
        x = couple(_with_gray(decouple(x), clean_gray))  # the known gray channel in place
        x_mean = x
        timesteps = torch.linspace(sde.T, eps, sde.N, device=gray_image.device)
        frames = []
        for i in range(sde.N):
            vec_t = timesteps[i].expand(B)
            x, _ = corrector_fn(noise, x, vec_t, sde=sde, score_fn=score_fn, snr=snr, n_steps=n_steps)
            x = project(noise, x, gray_image, vec_t)
            x, x_mean = predictor_fn(noise, x, vec_t, sde=sde, score_fn=score_fn, probability_flow=probability_flow)
            x = project(noise, x, gray_image, vec_t)
            x_mean = couple(_with_gray(decouple(x_mean), clean_gray))
            if show_evolution:
                frames.append(x)
        samples = x_mean if denoise else x
        info = {"evolution": _stacked(frames)} if show_evolution else {}
        return samples, info

    return colorizer
