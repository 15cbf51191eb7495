"""Predictor-corrector samplers (JAX `sampling/pc.py`): the unconditional
`get_pc_sampler` / `get_sampling_fn` (whose ``ode`` method is
`sampling/ode.py`), the conditional `get_pc_conditional_sampler` /
`get_conditional_sampling_fn`, and the inpainter `get_pc_inpainter` /
`get_inpainting_fn`.

The JAX samplers are one `lax.scan` each; here each is a Python loop over
the timestep grid that stays on the device (no host sync per step).

All random draws go through one noise source, ``noise(shape)`` -> standard
normal values.  A `torch.Generator` is wrapped by :func:`gaussian_noise`;
tests pass a callable that replays the JAX key chain's draws.  The order of
draws is the JAX sampler's order of use: the prior, then for each step
(unconditional) the corrector's and then the predictor's draws;
(conditional, fresh-perturbation mode) the corrector's y, the corrector,
the predictor's y and the predictor; (``use_path`` mode) y at T + tau once,
then for each step the backward-kernel draw, the predictor and the
corrector; (inpainter) the prior, then for each step the corrector's, the
projection's, the predictor's and the projection's again.  A corrector
draws once for each of its ``n_steps``, a predictor once (``none``:
never), a projection once.

``show_evolution=True`` keeps every step's state, as the JAX scan stacks it:
``info["evolution"]`` is x after each step, shape ``(p_steps, *shape)``,
for the unconditional sampler, and ``{'x', 'y'}`` (x and the y that the
step's predictor saw) for the conditional one.  It holds ``p_steps`` copies
of the batch: keep it off for a long run.
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


def _stacked(frames):
    if isinstance(frames[0], dict):
        return {k: torch.stack([f[k] for f in frames]) for k in frames[0]}
    return torch.stack(frames)


def get_pc_sampler(
    sde,
    shape: Sequence[int],
    predictor: str,
    corrector: str,
    snr: float,
    p_steps: int,
    c_steps: int = 1,
    probability_flow: bool = False,
    denoise: bool = True,
    eps: float = 1e-3,
) -> Callable:
    """Unconditional PC sampler.

    Returns ``sampler(noise, score_fn, show_evolution=False) -> (samples,
    info)``; ``noise`` is a `torch.Generator` or a noise source, and
    ``score_fn(x, t)`` a score function (`models.wrappers.get_score_fn`).
    The prior is drawn on the noise source's device.
    """
    predictor_fn = get_predictor(predictor)
    corrector_fn = get_corrector(corrector)

    def sampler(noise, score_fn, show_evolution: bool = False):
        noise = _as_noise(noise)
        x = sde.prior_sampling(noise, tuple(shape)).float()
        x_mean = x
        timesteps = torch.linspace(sde.T, eps, p_steps, device=x.device)
        frames = []
        for i in range(p_steps):
            vec_t = timesteps[i].expand(shape[0])
            x, x_mean = corrector_fn(noise, x, vec_t, sde=sde, score_fn=score_fn, snr=snr, n_steps=c_steps)
            x, x_mean = predictor_fn(noise, x, vec_t, sde=sde, score_fn=score_fn, probability_flow=probability_flow)
            if show_evolution:
                frames.append(x)
        samples = x_mean if denoise else x
        info = {"times": timesteps, "steps": p_steps * (c_steps + 1)}
        if show_evolution:
            info["evolution"] = _stacked(frames)
        return samples, info

    return sampler


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

    Returns ``sampler(noise, score_fn, y, show_evolution=False) ->
    (samples, info)``; ``noise`` is
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

    def sampler(noise, score_fn, y, show_evolution: bool = False):
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
        frames = []

        if multispeed and use_path:
            tau = timesteps[0] - timesteps[1]
            y_t = perturb_y((timesteps[0] + tau).expand(B))  # y at T + tau
        for i in range(p_steps):
            vec_t = timesteps[i].expand(B)
            if multispeed and use_path:
                y_mean, y_std = y_sde.compute_backward_kernel(y, y_t, vec_t, tau.expand(B))
                y_t = y_mean + batch_mul(y_std, noise(y.shape))
                x, x_mean = predictor_fn(noise, x, vec_t, y=y_t, **predictor_kwargs)
                x, x_mean = corrector_fn(noise, x, vec_t, y=y_t, **corrector_kwargs)
                y_p = y_t
            else:
                y_c = perturb_y(vec_t) if multispeed else y
                x, x_mean = corrector_fn(noise, x, vec_t, y=y_c, **corrector_kwargs)
                y_p = perturb_y(vec_t) if multispeed else y
                x, x_mean = predictor_fn(noise, x, vec_t, y=y_p, **predictor_kwargs)
            if show_evolution:
                frames.append({"x": x, "y": y_p})

        samples = x_mean if denoise else x
        info = {"times": timesteps, "steps": p_steps * (c_steps + 1)}
        if show_evolution:
            info["evolution"] = _stacked(frames)
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

    Returns ``fn(noise, model, y, show_evolution=False) -> (samples, info)``;
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

    def fn(noise, model, y, show_evolution: bool = False):
        raw_score_fn = get_score_fn(
            sde, model, conditional=True, train=False, continuous=config.training.continuous
        )
        score_fn = get_conditional_score_fn(raw_score_fn, target_domain="x")
        return pc(noise, score_fn, y, show_evolution=show_evolution)

    return fn


def get_sampling_fn(
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
):
    """Unconditional sampling function of a recipe (``sampling.method``
    ``pc``, or ``ode``: the probability-flow ODE sampler, which ignores
    ``show_evolution`` as JAX does).

    Returns ``fn(noise, model, show_evolution=False) -> (samples, info)``.
    """
    predictor, corrector, p_steps, c_steps, snr, denoise = _resolve(
        config, predictor, corrector, p_steps, c_steps, snr, denoise
    )
    method = config.sampling.method.lower()
    if method == "ode":
        from .ode import get_ode_sampler

        ode_sampler = get_ode_sampler(sde=sde, shape=shape, denoise=denoise, eps=eps)

        def ode_fn(noise, model, show_evolution: bool = False):
            score_fn = get_score_fn(sde, model, conditional=False, train=False, continuous=config.training.continuous)
            return ode_sampler(noise, score_fn)

        return ode_fn
    if method != "pc":
        raise ValueError(f"Sampler name {config.sampling.method!r} unknown.")

    pc = get_pc_sampler(
        sde=sde,
        shape=shape,
        predictor=predictor,
        corrector=corrector,
        snr=snr,
        p_steps=p_steps,
        c_steps=c_steps,
        probability_flow=config.sampling.probability_flow,
        denoise=denoise,
        eps=eps,
    )

    def fn(noise, model, show_evolution: bool = False):
        score_fn = get_score_fn(sde, model, conditional=False, train=False, continuous=config.training.continuous)
        return pc(noise, score_fn, show_evolution=show_evolution)

    return fn


def get_pc_inpainter(
    sde,
    predictor: str,
    corrector: str,
    snr: float,
    n_steps: int = 1,
    probability_flow: bool = False,
    denoise: bool = True,
    eps: float = 1e-5,
) -> Callable:
    """PC inpainter with a projection onto the known pixels after the
    corrector and after the predictor of each of ``sde.N`` steps.

    Returns ``inpainter(noise, score_fn, data, mask, show_evolution=False)
    -> (samples, info)``; ``mask`` is 1 on known pixels and broadcasts
    against ``data``.  With ``denoise`` the samples are the last
    projection's mean: the predictor's x off the mask, the data's marginal
    mean on it.
    """
    predictor_fn = get_predictor(predictor)
    corrector_fn = get_corrector(corrector)

    def project(noise, x, data, mask, vec_t):
        masked_mean, std = sde.marginal_prob(data, vec_t)
        masked = masked_mean + batch_mul(std, noise(x.shape))
        x_proj = x * (1.0 - mask) + masked * mask
        x_mean_proj = x * (1.0 - mask) + masked_mean * mask
        return x_proj, x_mean_proj

    def inpainter(noise, score_fn, data, mask, show_evolution: bool = False):
        noise = _as_noise(noise)
        B = data.shape[0]
        x = data * mask + sde.prior_sampling(noise, tuple(data.shape)) * (1.0 - mask)
        x_mean = x
        timesteps = torch.linspace(sde.T, eps, sde.N, device=data.device)
        frames = []
        for i in range(sde.N):
            vec_t = timesteps[i].expand(B)
            x, _ = corrector_fn(noise, x, vec_t, sde=sde, score_fn=score_fn, snr=snr, n_steps=n_steps)
            x, x_mean = project(noise, x, data, mask, vec_t)
            x, _ = predictor_fn(noise, x, vec_t, sde=sde, score_fn=score_fn, probability_flow=probability_flow)
            x, x_mean = project(noise, x, data, mask, vec_t)
            if show_evolution:
                frames.append(x)
        samples = x_mean if denoise else x
        info = {"evolution": _stacked(frames)} if show_evolution else {}
        return samples, info

    return inpainter


def get_inpainting_fn(config, sde, eps, n_steps_each: int = 1):
    """Inpainting function of a recipe: its predictor, corrector, snr and
    noise removal, ``sde.N`` steps.

    Returns ``fn(noise, model, data, mask, show_evolution=False) ->
    (samples, info)``.
    """
    inpainter = get_pc_inpainter(
        sde=sde,
        predictor=config.sampling.predictor.lower(),
        corrector=config.sampling.corrector.lower(),
        snr=config.sampling.snr,
        n_steps=n_steps_each,
        probability_flow=config.sampling.probability_flow,
        denoise=config.sampling.noise_removal,
        eps=eps,
    )

    def fn(noise, model, data, mask, show_evolution: bool = False):
        score_fn = get_score_fn(sde, model, conditional=False, train=False, continuous=config.training.continuous)
        return inpainter(noise, score_fn, data, mask, show_evolution=show_evolution)

    return fn
