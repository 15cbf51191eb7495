"""The port's predictor, corrector and conditional PC sampler against the
JAX ones, with the JAX key chain's noise injected into the port.

The JAX functions draw from `jax.random` keys; the tests re-derive the same
draws from the same key chain (`sampling/pc.py:165` and the branches after
it, `sampling/correctors.py:37-39`) and hand them to the port's noise
source in the order the port uses them.  Tolerance 1e-4, relative to the
result's largest magnitude for the whole sampler (its prior has std 277, so
float32 itself rounds at ~3e-5 there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_toy import (
    Replay,
    jax_sampler_draws,
    jax_toy_config,
    randomize_params,
    reset_jax_dispatch,
    toy_inputs,
    torch_toy_config,
)
from conditional_score_diffusion_tpu.models import init_model
from conditional_score_diffusion_tpu.models import layers as jax_layers
from conditional_score_diffusion_tpu.sampling import correctors as jax_correctors
from conditional_score_diffusion_tpu.sampling import pc as jax_pc
from conditional_score_diffusion_tpu.sampling import predictors as jax_predictors
from conditional_score_diffusion_tpu.sde import build_sde as jax_build_sde
from conditional_score_diffusion_tpu_torch.models import create_model
from conditional_score_diffusion_tpu_torch.models.convert import flax_to_state_dict
from conditional_score_diffusion_tpu_torch.sampling import (
    get_conditional_sampling_fn,
    get_corrector,
    get_pc_conditional_sampler,
    get_predictor,
)
from conditional_score_diffusion_tpu_torch.sde import build_sde

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


def _analytic_scores(sde_x):
    """A conditional score both frameworks compute: -(x - y) / (1 + sigma(t)^2)."""

    def jax_score(x, y, t):
        s = sde_x.marginal_prob(x, t)[1]
        return -(x - y) / (1.0 + s**2)[:, None, None, None]

    def torch_score(x, y, t):
        s = tsde["x"].marginal_prob(x, t)[1]
        return -(x - y) / (1.0 + s**2)[:, None, None, None]

    tsde, _ = build_sde(torch_toy_config(True))
    return jax_score, torch_score, tsde


@pytest.mark.parametrize("name", ["reverse_diffusion", "langevin"])
def test_step_matches_jax(name):
    jsde, _ = jax_build_sde(jax_toy_config(True))
    jax_score, torch_score, tsde = _analytic_scores(jsde["x"])
    x, y, _ = toy_inputs()
    x = x * 40.0
    t = np.array([0.7, 0.2], np.float32)
    key = jax.random.key(7)
    if name == "reverse_diffusion":
        jfn, tfn, kw = jax_predictors.reverse_diffusion, get_predictor("conditional_reverse_diffusion"), {}
        draws = [jax.random.normal(key, x.shape)]
    else:
        jfn, tfn = jax_correctors.langevin, get_corrector("conditional_langevin")
        kw = dict(snr=0.15, n_steps=2)
        draws = [jax.random.normal(jax.random.fold_in(key, i), x.shape) for i in range(2)]
    want = jfn(key, jnp.asarray(x), jnp.asarray(t), sde=jsde["x"], score_fn=jax_score, y=jnp.asarray(y), **kw)
    got = tfn(
        Replay(draws), torch.from_numpy(x), torch.from_numpy(t),
        sde=tsde["x"], score_fn=torch_score, y=torch.from_numpy(y), **kw,
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_single_sde_sampler_matches_jax():
    """With one SDE (the SR3 form) the clean y goes to the score as it is;
    3 steps with the analytic score."""
    jsde, _ = jax_build_sde(jax_toy_config(True))
    jax_score, torch_score, tsde = _analytic_scores(jsde["x"])
    _, y, _ = toy_inputs()
    kw = dict(shape=y.shape, predictor="reverse_diffusion", corrector="langevin", snr=0.15, p_steps=3)
    key = jax.random.key(5)
    want, _ = jax_pc.get_pc_conditional_sampler(jsde["x"], **kw)(key, jax_score, jnp.asarray(y))
    rng, prior = jax.random.split(key)
    draws = [jax.random.normal(prior, y.shape)]
    for _ in range(3):
        rng, rc, rp = jax.random.split(rng, 3)
        draws += [jax.random.normal(jax.random.fold_in(rc, 0), y.shape), jax.random.normal(rp, y.shape)]
    sampler = get_pc_conditional_sampler(tsde["x"], **kw)
    got, _ = sampler(Replay(draws), torch_score, torch.from_numpy(y))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.fixture(scope="module")
def jax_model():
    try:
        module, params = init_model(jax_toy_config(fused_tail=True), jax.random.key(0))
    finally:
        reset_jax_dispatch()
    return module, randomize_params(jax.device_get(params))


@pytest.mark.parametrize("use_path", [False, True])
def test_sampler_matches_jax(jax_model, use_path):
    """4 steps of the whole conditional PC sampler on the toy model, fused
    tail on in both frameworks."""
    p_steps = 4
    module, params = jax_model
    jconfig = jax_toy_config(fused_tail=True)
    try:
        _, y, _ = toy_inputs()
        shape = y.shape
        jsde, eps = jax_build_sde(jconfig)
        jax_layers.set_fused_gn_conv_dispatch(jax_layers.fused_tail_candidate_policy)
        fn = jax_pc.get_conditional_sampling_fn(
            jconfig, jsde, shape, eps, module, p_steps=p_steps, use_path=use_path
        )
        key = jax.random.key(11)
        want, info = fn(key, params, jnp.asarray(y))
        want = np.asarray(want)
    finally:
        reset_jax_dispatch()

    tconfig = torch_toy_config(True)
    model = create_model(tconfig, device="cpu")
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    tsde, teps = build_sde(tconfig)
    tfn = get_conditional_sampling_fn(tconfig, tsde, shape, teps, p_steps=p_steps, use_path=use_path)
    noise = Replay(jax_sampler_draws(key, p_steps, shape, use_path))
    got, tinfo = tfn(noise, model, torch.from_numpy(y))
    assert not noise.draws  # every draw used
    assert tinfo["steps"] == info["steps"] == 2 * p_steps
    np.testing.assert_allclose(tinfo["times"].numpy(), np.asarray(info["times"]), rtol=1e-6)
    assert got.shape == shape and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
