"""The port's probability-flow ODE sampler (`sampling/ode.py`, the ``ode``
method of `get_sampling_fn`) against the JAX package's.

* `get_ode_sampler` on a 16px NCSN++ with FIR and on a 16px DDPM, the same
  weights and the same prior draw ``z``, with and without the denoise step:
  samples at 1e-4 of their scale (the JAX package's sampler bound).
* `get_sampling_fn` with ``sampling.method = "ode"`` under VE and VP, the
  prior (and the denoise draw) replayed from the JAX key chain, 1e-4.
* By distribution, as JAX `tests/test_sampling.py:201-206`: 2048 x 1
  samples from the exact score of N(1.5, 0.5^2) under VE (N = 200), mean
  and std within 0.08.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_port_toy import Replay, reset_jax_dispatch, unconditional_toy_pair
from conditional_score_diffusion_tpu.models.wrappers import get_score_fn as jax_get_score_fn
from conditional_score_diffusion_tpu.sampling import pc as jax_pc
from conditional_score_diffusion_tpu.sampling.ode import get_ode_sampler as jax_get_ode_sampler
from conditional_score_diffusion_tpu.sde import build_sde as jax_build_sde
from conditional_score_diffusion_tpu_torch.models.wrappers import get_score_fn
from conditional_score_diffusion_tpu_torch.sampling import get_ode_sampler, get_sampling_fn
from conditional_score_diffusion_tpu_torch.sde import VESDE, batch_mul, build_sde

torch.set_num_threads(1)

SHAPE = (2, 16, 16, 3)


def hold(got, want, tol=1e-4):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("denoise", [False, True], ids=["plain", "denoise"])
@pytest.mark.parametrize("name", ["ncsnpp", "ddpm"])
def test_ode_sampler_matches_jax(name, denoise):
    jconfig, tconfig, module, params, model = unconditional_toy_pair(name)
    z = np.random.RandomState(3).randn(*SHAPE).astype(np.float32)
    try:
        jsde, eps = jax_build_sde(jconfig)
        jscore = jax_get_score_fn(jsde, module, params, continuous=jconfig.training.continuous)
        want, info = jax_get_ode_sampler(jsde, SHAPE, denoise=denoise, eps=eps)(
            jax.random.key(0), jscore, z=jax.numpy.asarray(z * jsde.sigma_max)
        )
    finally:
        reset_jax_dispatch()
    sde, teps = build_sde(tconfig)
    score = get_score_fn(sde, model, continuous=tconfig.training.continuous)
    got, tinfo = get_ode_sampler(sde, SHAPE, denoise=denoise, eps=teps)(
        torch.Generator().manual_seed(0), score, z=torch.from_numpy(z) * sde.sigma_max
    )
    assert tinfo == info == {"nfe": -1}
    hold(got, want)


@pytest.mark.parametrize("sde_name", ["vesde", "vpsde"])
def test_sampling_fn_ode_branch_matches_jax(sde_name):
    """The recipe's ``ode`` method (denoise on, the recipe's default):
    JAX splits its key three ways, the prior and the denoise draw."""
    jconfig, tconfig, module, params, model = unconditional_toy_pair("ncsnpp", sde_name, seed=9)
    for c in (jconfig, tconfig):
        c.sampling.method = "ode"
    key = jax.random.key(31)
    try:
        jsde, eps = jax_build_sde(jconfig)
        want, info = jax_pc.get_sampling_fn(jconfig, jsde, SHAPE, eps, module)(key, params, show_evolution=True)
    finally:
        reset_jax_dispatch()
    _, prior, denoise = jax.random.split(key, 3)
    noise = Replay([jax.random.normal(prior, SHAPE), jax.random.normal(denoise, SHAPE)])
    sde, teps = build_sde(tconfig)
    got, tinfo = get_sampling_fn(tconfig, sde, SHAPE, teps)(noise, model, show_evolution=True)
    assert not noise.draws and tinfo == info == {"nfe": -1}
    hold(got, want)


MU, S = 1.5, 0.5


def test_ode_sampler_recovers_a_gaussian():
    sde = VESDE(sigma_min=0.01, sigma_max=10.0, N=200)

    def score(x, t):
        std = sde.marginal_prob(x, t)[1]
        return -batch_mul(1.0 / (S**2 + std**2), x - MU)

    samples, info = get_ode_sampler(sde, (2048, 1), denoise=False, eps=1e-4)(torch.Generator().manual_seed(0), score)
    assert samples.shape == (2048, 1) and info == {"nfe": -1}
    assert abs(samples.mean().item() - MU) < 0.08 and abs(samples.std().item() - S) < 0.08
