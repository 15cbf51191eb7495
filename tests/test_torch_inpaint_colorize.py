"""The port's inpainter (`get_pc_inpainter`, `get_inpainting_fn`,
`HaarMultiScaleTask.inpaint_hf`), colorizer (`get_pc_colorizer`) and
`grayscale` against the JAX package's.

* Three steps (an SDE with N = 3) on a 16px NCSN++ with FIR and the same
  weights, the JAX key chain's draws replayed
  (`_torch_port_toy.jax_projected_draws`: the prior, then each step the
  corrector's, the projection's, the predictor's and the projection's
  draws): samples at 1e-4 of their scale, with and without the denoise
  step, and every step's x.
* `inpaint_hf` on a toy Haar DDPM (32px images: 16x16x12 coefficients),
  3 steps, against JAX's `HaarMultiScaleTask.inpaint_hf`.
* JAX's statistical tests (`tests/test_sampling.py:185-199, 226-264`)
  copied: the inpainter keeps the known pixels and draws the rest from the
  exact score's law; the colorizer keeps the gray channel (1e-4) and
  recovers the chroma's law (0.05); couple(decouple(x)) = x.
* `grayscale` bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_toy import Replay, jax_init_params, jax_projected_draws, ncsnpp_toy_config, reset_jax_dispatch
from conditional_score_diffusion_tpu.configs import base as jax_base
from conditional_score_diffusion_tpu.configs.extra import haar_multiscale_unconditional_config as jax_haar_config
from conditional_score_diffusion_tpu.data.degradations import grayscale as jax_grayscale
from conditional_score_diffusion_tpu.models.wrappers import get_score_fn as jax_get_score_fn
from conditional_score_diffusion_tpu.sampling import controllable as jax_controllable
from conditional_score_diffusion_tpu.sampling import pc as jax_pc
from conditional_score_diffusion_tpu.sde import build_sde as jax_build_sde
from conditional_score_diffusion_tpu.training.tasks import create_task as jax_create_task
from conditional_score_diffusion_tpu_torch.configs import base as torch_base
from conditional_score_diffusion_tpu_torch.configs import haar_multiscale_unconditional_config
from conditional_score_diffusion_tpu_torch.data.degradations import grayscale
from conditional_score_diffusion_tpu_torch.models import create_model
from conditional_score_diffusion_tpu_torch.models.convert import flax_to_state_dict
from conditional_score_diffusion_tpu_torch.models.wrappers import get_score_fn
from conditional_score_diffusion_tpu_torch.sampling import get_inpainting_fn, get_pc_colorizer, get_pc_inpainter
from conditional_score_diffusion_tpu_torch.sampling.controllable import couple, decouple
from conditional_score_diffusion_tpu_torch.sde import VESDE, batch_mul, build_sde
from conditional_score_diffusion_tpu_torch.training.tasks import create_task

torch.set_num_threads(1)

STEPS = 3
SHAPE = (2, 16, 16, 3)
PREDICTOR, CORRECTOR, SNR = "reverse_diffusion", "langevin", 0.16


def hold(got, want, tol=1e-4):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def toy(seed=7):
    """The 16px NCSN++ toy over an SDE of ``STEPS`` steps in both frameworks."""
    jconfig, tconfig = ncsnpp_toy_config(jax_base), ncsnpp_toy_config(torch_base)
    for c in (jconfig, tconfig):
        c.model.num_scales = STEPS
        c.sampling.predictor, c.sampling.corrector, c.sampling.snr = PREDICTOR, CORRECTOR, SNR
    module, params = jax_init_params(jconfig, seed=seed)
    model = create_model(tconfig, device="cpu")
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return jconfig, tconfig, module, params, model


def inputs(seed=3):
    rng = np.random.RandomState(seed)
    data = rng.rand(*SHAPE).astype(np.float32)
    mask = np.zeros(SHAPE[:-1] + (1,), np.float32)
    mask[:, 4:12, 2:10] = 1.0
    return data, mask


@pytest.mark.parametrize("denoise", [True, False], ids=["denoise", "plain"])
def test_pc_inpainter_matches_jax(denoise):
    jconfig, tconfig, module, params, model = toy()
    data, mask = inputs()
    key = jax.random.key(5)
    try:
        jsde, eps = jax_build_sde(jconfig)
        jscore = jax_get_score_fn(jsde, module, params, continuous=True)
        want, info = jax_pc.get_pc_inpainter(jsde, PREDICTOR, CORRECTOR, SNR, denoise=denoise, eps=eps)(
            key, jscore, jnp.asarray(data), jnp.asarray(mask), show_evolution=True
        )
    finally:
        reset_jax_dispatch()
    sde, teps = build_sde(tconfig)
    noise = Replay(jax_projected_draws(key, STEPS, SHAPE, PREDICTOR, CORRECTOR))
    got, tinfo = get_pc_inpainter(sde, PREDICTOR, CORRECTOR, SNR, denoise=denoise, eps=teps)(
        noise, get_score_fn(sde, model, continuous=True), torch.from_numpy(data), torch.from_numpy(mask),
        show_evolution=True,
    )
    assert not noise.draws
    hold(got, want)
    assert tinfo["evolution"].shape == (STEPS, *SHAPE)
    hold(tinfo["evolution"], info["evolution"])


def test_inpainting_fn_matches_jax():
    """The recipe's inpainter: its predictor, corrector, snr and denoise."""
    jconfig, tconfig, module, params, model = toy(seed=8)
    data, mask = inputs(seed=4)
    key = jax.random.key(6)
    try:
        jsde, eps = jax_build_sde(jconfig)
        want, info = jax_pc.get_inpainting_fn(jconfig, jsde, eps, module)(key, params, jnp.asarray(data),
                                                                         jnp.asarray(mask))
    finally:
        reset_jax_dispatch()
    sde, teps = build_sde(tconfig)
    noise = Replay(jax_projected_draws(key, STEPS, SHAPE, PREDICTOR, CORRECTOR))
    got, tinfo = get_inpainting_fn(tconfig, sde, teps)(noise, model, torch.from_numpy(data), torch.from_numpy(mask))
    assert not noise.draws and tinfo == info == {}
    hold(got, want)
    known = mask.astype(bool).repeat(3, axis=-1)
    assert np.array_equal(got.numpy()[known], data[known])  # under VE the marginal mean is the data


@pytest.mark.parametrize("denoise", [True, False], ids=["denoise", "plain"])
def test_pc_colorizer_matches_jax(denoise):
    jconfig, tconfig, module, params, model = toy(seed=9)
    data, _ = inputs(seed=5)
    gray = np.repeat(jax_grayscale(data), 3, axis=-1)
    key = jax.random.key(7)
    try:
        jsde, eps = jax_build_sde(jconfig)
        jscore = jax_get_score_fn(jsde, module, params, continuous=True)
        want, info = jax_controllable.get_pc_colorizer(jsde, PREDICTOR, CORRECTOR, SNR, denoise=denoise, eps=eps)(
            key, jscore, jnp.asarray(gray), show_evolution=True
        )
    finally:
        reset_jax_dispatch()
    sde, teps = build_sde(tconfig)
    noise = Replay(jax_projected_draws(key, STEPS, SHAPE, PREDICTOR, CORRECTOR))
    got, tinfo = get_pc_colorizer(sde, PREDICTOR, CORRECTOR, SNR, denoise=denoise, eps=teps)(
        noise, get_score_fn(sde, model, continuous=True), torch.from_numpy(gray), show_evolution=True
    )
    assert not noise.draws
    hold(got, want)
    hold(tinfo["evolution"], info["evolution"])
    if denoise:
        np.testing.assert_allclose(decouple(got)[..., 0].numpy(), decouple(torch.from_numpy(gray))[..., 0].numpy(),
                                   atol=1e-4)


def test_inpaint_hf_matches_jax():
    """The detail bands given the DC band: a DDPM of 12 Haar channels at
    16x16 (nf 16, ch_mult (1, 2)), 3 steps."""
    jconfig = jax_haar_config(32)
    tconfig = haar_multiscale_unconditional_config(32)
    for c in (jconfig, tconfig):
        c.model.nf, c.model.ch_mult, c.model.num_res_blocks, c.model.attn_resolutions = 16, (1, 2), 1, (8,)
        c.model.num_scales = STEPS
    module, params = jax_init_params(jconfig, seed=10)
    model = create_model(tconfig, device="cpu")
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    dc = np.random.RandomState(11).randn(2, 16, 16, 3).astype(np.float32)
    key = jax.random.key(8)
    try:
        want, info = jax_create_task(jconfig, module).inpaint_hf(key, params, jnp.asarray(dc))
    finally:
        reset_jax_dispatch()
    task = create_task(tconfig, model)
    predictor, corrector = tconfig.sampling.predictor, tconfig.sampling.corrector
    noise = Replay(jax_projected_draws(key, STEPS, (2, 16, 16, 12), predictor, corrector))
    got, tinfo = task.inpaint_hf(noise, model, torch.from_numpy(dc))
    assert not noise.draws and tinfo == info == {}
    hold(got, want)
    assert torch.equal(got[..., :3], torch.from_numpy(dc))


def test_grayscale_is_jaxs():
    batch = np.random.RandomState(12).rand(3, 8, 8, 3).astype(np.float32)
    got, want = grayscale(batch), jax_grayscale(batch)
    assert got.shape == (3, 8, 8, 1) and got.dtype == want.dtype and np.array_equal(got, want)


# ---- JAX's statistical tests, copied ----------------------------------------

MU, S = 1.5, 0.5


def exact_score(sde):
    def score(x, t):
        return -batch_mul(1.0 / (S**2 + sde.marginal_prob(x, t)[1] ** 2), x - MU)

    return score


def test_inpainter_keeps_known_pixels_and_draws_the_rest():
    sde = VESDE(sigma_min=0.01, sigma_max=10.0, N=200)
    inpainter = get_pc_inpainter(sde, "reverse_diffusion", "langevin", snr=0.15, n_steps=1, denoise=True, eps=1e-5)
    data = torch.full((256, 4), MU)
    mask = torch.zeros(256, 4)
    mask[:, :2] = 1.0
    out, _ = inpainter(torch.Generator().manual_seed(0), exact_score(sde), data, mask)
    np.testing.assert_allclose(out[:, :2].numpy(), MU, atol=1e-3)
    assert abs(out[:, 2:].mean().item() - MU) < 0.1 and abs(out[:, 2:].std().item() - S) < 0.1


def test_colorizer_keeps_gray_and_recovers_chroma():
    sde = VESDE(sigma_min=0.01, sigma_max=10.0, N=100)
    colorizer = get_pc_colorizer(sde, "reverse_diffusion", "langevin", snr=0.15, n_steps=1, denoise=True, eps=1e-5)
    gray = torch.full((64, 8, 8, 3), MU)
    out, _ = colorizer(torch.Generator().manual_seed(0), exact_score(sde), gray)
    assert out.shape == (64, 8, 8, 3) and torch.isfinite(out).all()
    np.testing.assert_allclose(decouple(out)[..., 0].numpy(), decouple(gray)[..., 0].numpy(), atol=1e-4)
    chroma = decouple(out)[..., 1:]
    assert abs(chroma.mean().item()) < 0.05 and abs(chroma.std().item() - S) < 0.05
    assert abs(out.mean().item() - MU) < 0.05


def test_couple_decouple_roundtrip():
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 4, 4, 3).astype(np.float32))
    np.testing.assert_allclose(couple(decouple(x)).numpy(), x.numpy(), atol=1e-6)
    jx = jnp.asarray(x.numpy())
    np.testing.assert_allclose(decouple(x).numpy(), np.asarray(jax_controllable.decouple(jx)), atol=1e-6)
