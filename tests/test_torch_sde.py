"""The port's multi-speed VE SDE against the JAX one, to 1e-5.

Both are built from the same flagship CMDE recipe (JAX ml_collections, port
plain Python): {'x': VESDE(sigma_max_x = sqrt(3*160*160)), 'y': VESDE(0.5)}.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conditional_score_diffusion_tpu.configs.celeba_sr import celeba_sr_160_config as jax_recipe
from conditional_score_diffusion_tpu.sde import build_sde as jax_build_sde
from conditional_score_diffusion_tpu_torch.configs import celeba_sr_160_config, texture160_sr_cmde_config
from conditional_score_diffusion_tpu_torch.sde import build_sde

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def sdes():
    jsde, jeps = jax_build_sde(jax_recipe("ours_NDV"))
    tsde, teps = build_sde(celeba_sr_160_config("ours_NDV"))
    assert jeps == teps
    return jsde, tsde


def _data(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(4, 8, 8, 3).astype(np.float32)
    # t on the sampler's grid ends and inside; 0 exercises discretize's first step
    t = np.array([1.0, 0.5, 1e-5, 0.0], np.float32)
    return x, t


@pytest.mark.parametrize("domain", ["x", "y"])
def test_sde_math_matches_jax(sdes, domain):
    jsde, tsde = sdes
    j, p = jsde[domain], tsde[domain]
    assert (p.sigma_min, p.sigma_max, p.N) == (float(j.sigma_min), float(j.sigma_max), j.N)
    x, t = _data()
    jx, jt, tx, tt = jnp.asarray(x), jnp.asarray(t), torch.from_numpy(x), torch.from_numpy(t)

    for jf, tf in [(j.marginal_prob, p.marginal_prob), (j.sde, p.sde), (j.discretize, p.discretize)]:
        for a, b in zip(jf(jx, jt), tf(tx, tt)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)

    np.testing.assert_allclose(
        p.discrete_sigmas("cpu").numpy(), np.asarray(j.discrete_sigmas), **TOL
    )

    x0 = np.random.RandomState(1).randn(4, 8, 8, 3).astype(np.float32)
    tau = np.full((4,), 1e-3, np.float32)
    t_in = np.array([0.9, 0.5, 0.1, 1e-5], np.float32)
    jm, js = j.compute_backward_kernel(jnp.asarray(x0), jx, jnp.asarray(t_in), jnp.asarray(tau))
    tm, ts = p.compute_backward_kernel(torch.from_numpy(x0), tx, torch.from_numpy(t_in), torch.from_numpy(tau))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("domain", ["x", "y"])
def test_prior_sampling_matches_jax(sdes, domain):
    """Given the same standard normal draws, the priors agree; and a port draw
    from a torch generator has the prior's std."""
    jsde, tsde = sdes
    z = np.array(jax.random.normal(jax.random.key(3), (2, 16, 16, 3)))
    want = np.asarray(jsde[domain].prior_sampling(jax.random.key(3), (2, 16, 16, 3)))
    got = tsde[domain].prior_sampling(lambda shape: torch.from_numpy(z), (2, 16, 16, 3))
    np.testing.assert_allclose(got.numpy(), want, **TOL)

    g = torch.Generator().manual_seed(0)
    draw = tsde[domain].prior_sampling(lambda shape: torch.randn(shape, generator=g), (64, 32, 32, 3))
    assert abs(draw.std().item() / tsde[domain].sigma_max - 1) < 0.02


def test_texture160_recipe_is_the_flagship_with_the_tail_on():
    from configs.artifacts.texture160_sr_cmde import get_config as jax_texture_config

    j, p = jax_texture_config(), texture160_sr_cmde_config()
    for section in ("training", "sampling", "data", "model"):
        jd = getattr(j, section).to_dict()
        pd = vars(getattr(p, section))
        for key, value in jd.items():
            got = pd[key]
            if isinstance(value, (list, tuple)):
                value, got = list(value), list(got)
            assert got == value, (section, key)
    assert p.model.fused_tail is True and "fused_tail" not in j.model
    assert p.eval.batch_size == j.eval.batch_size == 8
