"""Conditional predictor-corrector sampler (JAX `sampling/pc.py`:
`get_pc_conditional_sampler`, `get_conditional_sampling_fn`).

The JAX sampler is one `lax.scan`; here it is a Python loop over the
timestep grid that stays on the device (no host sync per step).

All random draws go through one noise source, ``noise(shape)`` -> standard
normal values.  A `torch.Generator` is wrapped by :func:`gaussian_noise`;
tests pass a callable that replays the JAX key chain's draws.  The order of
draws is the JAX sampler's order of use: the prior, then for each step
(fresh-perturbation mode) the corrector's y, the corrector, the predictor's
y and the predictor; (``use_path`` mode) y at T + tau once, then for each
step the backward-kernel draw, the predictor and the corrector.
"""

from __future__ import annotations

from typing import Callable, Sequence, Union

import torch

from ..models.wrappers import get_conditional_score_fn, get_score_fn
from ..sde import batch_mul, is_multispeed
from .correctors import get_corrector
from .predictors import get_predictor

NoiseSource = Callable[[Sequence[int]], torch.Tensor]


def gaussian_noise(generator: torch.Generator) -> NoiseSource:
    """Standard normal draws from ``generator``, on its device."""

    def noise(shape):
        return torch.randn(tuple(shape), generator=generator, device=generator.device)

    return noise


def _as_noise(noise: Union[torch.Generator, NoiseSource]) -> NoiseSource:
    return gaussian_noise(noise) if isinstance(noise, torch.Generator) else noise


def _resolve(config, predictor, corrector, p_steps, c_steps, snr, denoise):
    """Apply the 'default' -> recipe fallbacks."""
    if predictor == "default":
        predictor = config.sampling.predictor
    if corrector == "default":
        corrector = config.sampling.corrector
    if p_steps == "default":
        p_steps = config.model.num_scales
    if c_steps == "default":
        c_steps = config.sampling.n_steps_each
    if snr == "default":
        snr = config.sampling.snr
    if denoise == "default":
        denoise = config.sampling.noise_removal
    return predictor.lower(), corrector.lower(), p_steps, c_steps, snr, denoise


def get_pc_conditional_sampler(
    sde,
    shape: Sequence[int],
    predictor: str,
    corrector: str,
    snr: float,
    p_steps: int,
    c_steps: int = 1,
    probability_flow: bool = False,
    denoise: bool = True,
    use_path: bool = False,
    eps: float = 1e-5,
) -> Callable:
    """Conditional PC sampler (CDE/CDiffE/CMDE inference).

    Returns ``sampler(noise, score_fn, y) -> (samples, info)``; ``noise`` is
    a `torch.Generator` or a noise source, ``score_fn(x, y, t)`` the
    conditional score of the target domain and ``y`` the clean condition
    (NHWC, on the device to sample on).

    Two modes for a multi-speed SDE:
      * default: the corrector and then the predictor each re-perturb the
        clean ``y`` through ``sde['y'].marginal_prob(y, t)`` with fresh noise;
      * ``use_path=True``: ``y_t`` follows one correlated forward path through
        the backward kernel ``p(y_t | y_0, y_{t+tau})``; the predictor runs
        first and the corrector reuses its ``y_t``.
    With a single SDE, the clean ``y`` goes to the score as it is.
    """
    predictor_fn = get_predictor(predictor)
    corrector_fn = get_corrector(corrector)
    multispeed = is_multispeed(sde)
    c_sde = sde["x"] if multispeed else sde
    y_sde = sde["y"] if multispeed else None

    def sampler(noise, score_fn, y):
        noise = _as_noise(noise)
        B = y.shape[0]

        def perturb_y(vec_t):
            mean, std = y_sde.marginal_prob(y, vec_t)
            return mean + batch_mul(std, noise(y.shape))

        x = c_sde.prior_sampling(noise, tuple(shape)).float()
        x_mean = x
        timesteps = torch.linspace(c_sde.T, eps, p_steps, device=y.device)
        corrector_kwargs = dict(sde=c_sde, score_fn=score_fn, snr=snr, n_steps=c_steps)
        predictor_kwargs = dict(sde=c_sde, score_fn=score_fn, probability_flow=probability_flow)

        if multispeed and use_path:
            tau = timesteps[0] - timesteps[1]
            y_t = perturb_y((timesteps[0] + tau).expand(B))  # y at T + tau
            for i in range(p_steps):
                vec_t = timesteps[i].expand(B)
                y_mean, y_std = y_sde.compute_backward_kernel(y, y_t, vec_t, tau.expand(B))
                y_t = y_mean + batch_mul(y_std, noise(y.shape))
                x, x_mean = predictor_fn(noise, x, vec_t, y=y_t, **predictor_kwargs)
                x, x_mean = corrector_fn(noise, x, vec_t, y=y_t, **corrector_kwargs)
        elif multispeed:
            for i in range(p_steps):
                vec_t = timesteps[i].expand(B)
                x, x_mean = corrector_fn(noise, x, vec_t, y=perturb_y(vec_t), **corrector_kwargs)
                x, x_mean = predictor_fn(noise, x, vec_t, y=perturb_y(vec_t), **predictor_kwargs)
        else:
            for i in range(p_steps):
                vec_t = timesteps[i].expand(B)
                x, x_mean = corrector_fn(noise, x, vec_t, y=y, **corrector_kwargs)
                x, x_mean = predictor_fn(noise, x, vec_t, y=y, **predictor_kwargs)

        samples = x_mean if denoise else x
        info = {"times": timesteps, "steps": p_steps * (c_steps + 1)}
        return samples, info

    return sampler


def get_conditional_sampling_fn(
    config,
    sde,
    shape,
    eps,
    predictor="default",
    corrector="default",
    p_steps="default",
    c_steps="default",
    snr="default",
    denoise="default",
    use_path="default",
):
    """Conditional sampling function of a recipe.

    Returns ``fn(noise, model, y) -> (samples, info)``;
    ``model`` is the paired score network (e.g. ``ddpm_paired``).
    """
    predictor, corrector, p_steps, c_steps, snr, denoise = _resolve(
        config, predictor, corrector, p_steps, c_steps, snr, denoise
    )
    if use_path == "default":
        use_path = False

    pc = get_pc_conditional_sampler(
        sde=sde,
        shape=shape,
        predictor=predictor,
        corrector=corrector,
        snr=snr,
        p_steps=p_steps,
        c_steps=c_steps,
        probability_flow=config.sampling.probability_flow,
        denoise=denoise,
        use_path=use_path,
        eps=eps,
    )

    def fn(noise, model, y):
        raw_score_fn = get_score_fn(
            sde, model, conditional=True, train=False, continuous=config.training.continuous
        )
        score_fn = get_conditional_score_fn(raw_score_fn, target_domain="x")
        return pc(noise, score_fn, y)

    return fn
