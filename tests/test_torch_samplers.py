"""The port's unconditional PC sampler (`get_pc_sampler`, `get_sampling_fn`)
and `show_evolution` of both samplers against the JAX package's.

* Three steps of `get_sampling_fn` on a 16px NCSN++ with the same weights,
  for predictor-corrector pairs under VE, VP and sub-VP, with the JAX key
  chain's draws replayed (`_torch_port_toy.jax_unconditional_draws`): the
  samples and every step's x (`show_evolution`) at 1e-4 of their largest
  magnitude.
* By distribution, as JAX `tests/test_sampling.py:32-62` holds its
  samplers: with the exact score of Gaussian data N(1.5, 0.5^2), the
  samples' mean and std within 0.08-0.1 of the data's, under VE (its test's
  SDE, N = 200) and VP (N = 1000).
* The conditional sampler's evolution ``{'x', 'y'}`` against JAX's in its
  three modes (fresh perturbation, ``use_path``, one SDE) on the toy
  `ddpm_paired`, 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_toy import (
    Replay,
    jax_init_params,
    jax_sampler_draws,
    jax_toy_config,
    jax_toy_params,
    jax_unconditional_draws,
    ncsnpp_toy_config,
    reset_jax_dispatch,
    toy_inputs,
    torch_toy_config,
)
from conditional_score_diffusion_tpu.configs import base as jax_base
from conditional_score_diffusion_tpu.sampling import pc as jax_pc
from conditional_score_diffusion_tpu.sde import build_sde as jax_build_sde
from conditional_score_diffusion_tpu_torch.configs import base as torch_base
from conditional_score_diffusion_tpu_torch.models import create_model
from conditional_score_diffusion_tpu_torch.models.convert import flax_to_state_dict
from conditional_score_diffusion_tpu_torch.sampling import get_conditional_sampling_fn, get_pc_sampler, get_sampling_fn
from conditional_score_diffusion_tpu_torch.sde import VESDE, VPSDE, batch_mul, build_sde
from conditional_score_diffusion_tpu_torch.training.tasks import create_task

torch.set_num_threads(1)

P_STEPS = 3
RUNS = [
    ("vesde", "reverse_diffusion", "langevin"),
    ("vesde", "ancestral_sampling", "ald"),
    ("vesde", "euler_maruyama", "none"),
    ("vpsde", "euler_maruyama", "none"),
    ("vpsde", "ancestral_sampling", "langevin"),
    ("vpsde", "reverse_diffusion", "ald"),
    ("subvpsde", "euler_maruyama", "langevin"),
    ("subvpsde", "none", "ald"),
]


def hold(got, want, tol=1e-4):
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("run", RUNS, ids=["-".join(r) for r in RUNS])
def test_unconditional_sampler_matches_jax(run):
    sde_name, predictor, corrector = run
    jconfig, tconfig = ncsnpp_toy_config(jax_base), ncsnpp_toy_config(torch_base)
    for c in (jconfig, tconfig):
        c.training.sde = sde_name
        c.sampling.snr = 0.16
    module, params = jax_init_params(jconfig, seed=7)
    shape = (2, 16, 16, 3)
    key = jax.random.key(21)
    try:
        jsde, eps = jax_build_sde(jconfig)
        fn = jax_pc.get_sampling_fn(jconfig, jsde, shape, eps, module, predictor=predictor, corrector=corrector,
                                    p_steps=P_STEPS)
        want, info = fn(key, params, show_evolution=True)
    finally:
        reset_jax_dispatch()
    model = create_model(tconfig, device="cpu")
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    task = create_task(tconfig, model)  # the `base` task: an unconditional model
    assert not task.conditional
    noise = Replay(jax_unconditional_draws(key, P_STEPS, shape, predictor, corrector))
    got, tinfo = task.sampling_fn(shape, predictor=predictor, corrector=corrector, p_steps=P_STEPS)(
        noise, model, show_evolution=True
    )
    assert not noise.draws
    assert tinfo["steps"] == info["steps"] == 2 * P_STEPS
    np.testing.assert_allclose(tinfo["times"].numpy(), np.asarray(info["times"]), rtol=1e-6)
    hold(got.numpy(), want)
    assert tinfo["evolution"].shape == (P_STEPS, *shape)
    hold(tinfo["evolution"].numpy(), info["evolution"])


def test_sampling_fn_names_the_ode_item():
    """``sampling.method = "ode"`` samples through the probability-flow ODE
    (`tests/test_torch_ode.py` holds it against JAX); an unknown method
    raises."""
    config = ncsnpp_toy_config(torch_base)
    config.sampling.method = "ode"
    model = create_model(config, device="cpu")
    samples, info = get_sampling_fn(config, *build_sde(config)[:1], (1, 16, 16, 3), 1e-3)(
        torch.Generator().manual_seed(0), model
    )
    assert samples.shape == (1, 16, 16, 3) and torch.isfinite(samples).all() and info == {"nfe": -1}
    config.sampling.method = "flow"
    with pytest.raises(ValueError, match="flow"):
        get_sampling_fn(config, *build_sde(config)[:1], (1, 16, 16, 3), 1e-5)


MU, S = 1.5, 0.5


def gaussian_score(sde):
    """The exact score of data N(MU, S^2) under ``sde``'s perturbation."""

    def score(x, t):
        mean_coef, std = sde.marginal_prob(torch.ones_like(t), t)
        return -batch_mul(1.0 / (S**2 * mean_coef**2 + std**2), x - batch_mul(mean_coef, torch.full_like(x, MU)))

    return score


DISTRIBUTION_RUNS = [
    ("ve", "reverse_diffusion", "langevin", 200, 0.08),
    ("ve", "euler_maruyama", "none", 400, 0.1),
    ("ve", "ancestral_sampling", "none", 200, 0.08),
    ("vp", "euler_maruyama", "none", 1000, 0.08),
    ("vp", "ancestral_sampling", "langevin", 1000, 0.08),
]


@pytest.mark.parametrize("run", DISTRIBUTION_RUNS, ids=["-".join(map(str, r[:3])) for r in DISTRIBUTION_RUNS])
def test_unconditional_sampler_recovers_a_gaussian(run):
    kind, predictor, corrector, steps, tol = run
    sde = VESDE(sigma_min=0.01, sigma_max=10.0, N=steps) if kind == "ve" else VPSDE(N=steps)
    eps = 1e-5 if kind == "ve" else 1e-3
    sampler = get_pc_sampler(sde, (2048, 2), predictor, corrector, snr=0.15, p_steps=steps, denoise=True, eps=eps)
    samples, info = sampler(torch.Generator().manual_seed(0), gaussian_score(sde))
    assert info["steps"] == 2 * steps
    assert abs(samples.mean().item() - MU) < tol and abs(samples.std().item() - S) < tol


def test_evolution_is_opt_in_and_ends_at_x():
    sde = VESDE(sigma_min=0.01, sigma_max=10.0, N=10)
    sampler = get_pc_sampler(sde, (4, 2), "reverse_diffusion", "none", snr=0.0, p_steps=10, denoise=False)
    x, info = sampler(torch.Generator().manual_seed(1), gaussian_score(sde), show_evolution=True)
    assert info["evolution"].shape == (10, 4, 2) and torch.equal(info["evolution"][-1], x)
    _, info = sampler(torch.Generator().manual_seed(1), gaussian_score(sde))
    assert "evolution" not in info


MODES = [("multispeed", False), ("multispeed", True), ("single", False)]


@pytest.mark.parametrize("mode", MODES, ids=["fresh", "use_path", "single_sde"])
def test_conditional_evolution_matches_jax(mode):
    """The toy `ddpm_paired` under the CMDE dict SDE, or `ddpm_paired_SR3`
    under its x SDE alone."""
    kind, use_path = mode
    jconfig, tconfig = jax_toy_config(fused_tail=False), torch_toy_config(fused_tail=False)
    if kind == "single":
        for c in (jconfig, tconfig):
            c.model.name, c.model.output_channels = "ddpm_paired_SR3", 3
    module, params = jax_toy_params(jconfig, seed=8)
    _, y, _ = toy_inputs(seed=10)
    shape = y.shape
    key = jax.random.key(23)
    try:
        jsde, eps = jax_build_sde(jconfig)
        if kind == "single":
            jsde = jsde["x"]
        fn = jax_pc.get_conditional_sampling_fn(jconfig, jsde, shape, eps, module, p_steps=P_STEPS, use_path=use_path)
        want, info = fn(key, params, jnp.asarray(y), show_evolution=True)
    finally:
        reset_jax_dispatch()
    model = create_model(tconfig, device="cpu")
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    tsde, teps = build_sde(tconfig)
    if kind == "single":
        tsde = tsde["x"]
        draws = jax_unconditional_draws(key, P_STEPS, shape, "reverse_diffusion", "langevin")
    else:
        draws = jax_sampler_draws(key, P_STEPS, shape, use_path)
    noise = Replay(draws)
    fn = get_conditional_sampling_fn(tconfig, tsde, shape, teps, p_steps=P_STEPS, use_path=use_path)
    got, tinfo = fn(noise, model, torch.from_numpy(y), show_evolution=True)
    assert not noise.draws
    hold(got.numpy(), want)
    assert sorted(tinfo["evolution"]) == sorted(info["evolution"]) == ["x", "y"]
    for k in ("x", "y"):
        assert tinfo["evolution"][k].shape == (P_STEPS, *shape)
        hold(tinfo["evolution"][k].numpy(), info["evolution"][k])


# ---- what `chip_smoke.py` counts on the unconditional and VP paths ----------


@pytest.mark.parametrize("path", ["unconditional", "vpsde", "subvpsde"])
def test_chip_smoke_counts_per_forward(path):
    """One forward at full width on the meta device, as `chip_smoke.py`
    counts it: the unconditional NCSN++ (128px, B=8) calls each FIR kernel
    6 times (`PER_FORWARD_UNCOND_PATH`), at the six shapes that phase checks
    against the plain versions; DDPM++ under VP and sub-VP calls no kernel."""
    import chip_smoke
    from conditional_score_diffusion_tpu_torch.configs.extra import (
        cifar10_vp_config,
        texture160_unconditional_ncsnpp_config,
    )

    if path == "unconditional":
        calls = chip_smoke.forward_calls(texture160_unconditional_ncsnpp_config(), chip_smoke.UNCOND_BATCH)
        assert chip_smoke.per_name(calls) == chip_smoke.PER_FORWARD_UNCOND_PATH
        assert chip_smoke.sites(calls, "fir_downsample2") == {(128, 128, 128): 2, (64, 64, 128): 2, (32, 32, 256): 2}
        assert chip_smoke.sites(calls, "fir_upsample2") == {(16, 16, 256): 2, (32, 32, 256): 2, (64, 64, 128): 2}
    else:
        assert not chip_smoke.forward_calls(cifar10_vp_config(path), chip_smoke.VP_BATCH)
