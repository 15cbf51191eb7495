"""The paper's four other estimators in the port against the JAX package on
the toy `ddpm_paired` / `ddpm_paired_SR3` (`_torch_port_toy.shrink`: 32px,
nf=32, ch_mult (1, 2, 2)): VS-CMDE (``ours_DV``), the slow VS-CMDE
(``ours_slowDV``), CDiffE (``song``) and CDE (``sr3``), as
`tests/test_torch_train.py` and `tests/test_torch_sampler.py` hold CMDE.

* Three whole train steps (Adam, clip 1.0, EMA; batch 2, dropout 0) with
  the JAX key chain's t and noise injected: each step's loss (1e-5
  relative) and gradient norm (1e-4), and each tensor's update of the
  params after the three by norm (2e-3, the bound of
  `tests/test_torch_train.py`), tensors whose JAX gradient is rounding
  noise aside (below 1e-6 of the largest at some step).  For VS-CMDE the
  anneal is cut to ``reach_target_steps = 2``, so sigma_y takes its start,
  a middle value and its target over the three steps.
* A 3-step conditional PC sampler on the same weights with the JAX key
  chain's noise replayed, 1e-4 of the result's largest magnitude; for
  VS-CMDE through the task's `reconfigure` at the end of the anneal (the
  SDE a checkpoint at that step samples with).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_toy import Replay, jax_sampler_draws, jax_toy_params, reset_jax_dispatch, shrink, to_torch
from conditional_score_diffusion_tpu.configs.celeba_sr import celeba_sr_160_config as jax_recipe
from conditional_score_diffusion_tpu.losses import build_loss_fn as jax_build_loss_fn
from conditional_score_diffusion_tpu.sampling import pc as jax_pc
from conditional_score_diffusion_tpu.sde import build_sde as jax_build_sde
from conditional_score_diffusion_tpu.training import state as jax_state
from conditional_score_diffusion_tpu.training import steps as jax_steps
from conditional_score_diffusion_tpu.training.schedules import sigma_y_at_step as jax_sigma_y_at_step
from conditional_score_diffusion_tpu_torch.configs import celeba_sr_160_config
from conditional_score_diffusion_tpu_torch.models import create_model
from conditional_score_diffusion_tpu_torch.models.convert import flax_to_state_dict
from conditional_score_diffusion_tpu_torch.training.schedules import sigma_y_at_step
from conditional_score_diffusion_tpu_torch.training.state import create_train_state
from conditional_score_diffusion_tpu_torch.training.steps import make_train_step
from conditional_score_diffusion_tpu_torch.training.tasks import create_task

torch.set_num_threads(1)

APPROACHES = ["ours_DV", "ours_slowDV", "song", "sr3"]
KEY = jax.random.key(13)
STEPS = 3
LOSS_RTOL, GRAD_TOL, UPDATE_TOL, NOISE_LEVEL = 1e-5, 1e-4, 2e-3, 1e-6


def estimator_configs(approach):
    configs = []
    for recipe in (jax_recipe, celeba_sr_160_config):
        c = shrink(recipe(approach))
        c.model.dropout = 0.0
        c.training.batch_size = 2
        c.optim.warmup = 0
        if "decreasing_variance" in c.training.lightning_module:
            c.model.reach_target_steps = 2
        configs.append(c)
    return configs


def batch(seed=8):
    rng = np.random.RandomState(seed)
    return {"x": rng.rand(2, 32, 32, 3).astype(np.float32), "y": rng.rand(2, 32, 32, 3).astype(np.float32)}


def step_draws(approach, step, shapes):
    """The draws of JAX train step ``step``: the multi-speed loss's t and a
    normal per sorted domain; SR3's t and z (its key split in 3)."""
    key = jax.random.fold_in(KEY, step)
    if approach != "sr3":
        from _torch_port_toy import jax_loss_draws

        return jax_loss_draws(key, shapes)
    rng_t, rng_z, _ = jax.random.split(key, 3)
    B = shapes["x"][0]
    return {
        "t": np.asarray(jax.random.uniform(rng_t, (B,), minval=1e-5, maxval=1.0)),
        "x": np.asarray(jax.random.normal(rng_z, shapes["x"])),
    }


@pytest.mark.parametrize("approach", APPROACHES)
def test_train_steps_match_jax(approach):
    jconfig, tconfig = estimator_configs(approach)
    module, params = jax_toy_params(jconfig, seed=4)
    data = batch()
    try:
        train_step, tx = jax_steps.make_train_step(jconfig, module)
        sde_fn = jax_steps.make_sde_for_step(jconfig)
        loss_fn = jax_build_loss_fn(jconfig, module, sde_fn(0), train=True)
        step = jax.jit(train_step)
        jstate = jax_state.create_train_state(jconfig, params, tx)
        jmetrics, noise_tensors = [], set()
        for i in range(STEPS):
            g = jax.grad(lambda p: loss_fn(p, sde_fn(i), data, jax.random.fold_in(KEY, i)))(jstate.params)
            g = flax_to_state_dict(jax.device_get(g))
            top = max(v.abs().max().item() for v in g.values())
            noise_tensors |= {n for n, v in g.items() if v.abs().max().item() < NOISE_LEVEL * top}
            jstate, m = step(jstate, data, KEY)
            jmetrics.append({k: float(v) for k, v in m.items()})
    finally:
        reset_jax_dispatch()

    model = create_model(tconfig, device="cpu")
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    state = create_train_state(tconfig, model)
    port_step = make_train_step(tconfig, model)
    for i in range(STEPS):
        draws = step_draws(approach, i, {k: v.shape for k, v in data.items()})
        m = port_step(state, to_torch(data), noise=to_torch(draws))
        got, want = float(m["loss"]), jmetrics[i]
        assert abs(got - want["loss"]) <= LOSS_RTOL * abs(want["loss"]), (i, got, want)
        assert abs(float(m["grad_norm"]) - want["grad_norm"]) <= GRAD_TOL * want["grad_norm"], i
    start = flax_to_state_dict(params)
    last = flax_to_state_dict(jax.device_get(jstate.params))
    for name, p in state.model.named_parameters():
        if name in noise_tensors:
            continue
        upd_got, upd_want = p.detach() - start[name], last[name] - start[name]
        assert (upd_got - upd_want).norm() <= UPDATE_TOL * upd_want.norm(), name
    assert state.step == int(jstate.step) == STEPS
    if approach in ("ours_DV", "ours_slowDV"):  # the anneal ran: start, middle, target (float32)
        smax = [sigma_y_at_step(tconfig, s)[1] for s in range(STEPS)]
        assert smax[0] == np.float32(tconfig.model.sigma_max_y) and smax[2] == np.float32(tconfig.model.sigma_max_y_target)
        assert smax == [float(jax_sigma_y_at_step(jconfig, s)[1]) for s in range(STEPS)]


def sr3_draws(key, p_steps, shape):
    """The JAX single-SDE sampler's draws (`sampling/pc.py`: the prior, then
    each step the corrector's `fold_in(rc, 0)` and the predictor's)."""
    rng, prior = jax.random.split(key)
    draws = [jax.random.normal(prior, shape)]
    for _ in range(p_steps):
        rng, rc, rp = jax.random.split(rng, 3)
        draws += [jax.random.normal(jax.random.fold_in(rc, 0), shape), jax.random.normal(rp, shape)]
    return draws


@pytest.mark.parametrize("approach", APPROACHES)
def test_sampler_matches_jax(approach):
    p_steps = 3
    jconfig, tconfig = estimator_configs(approach)
    module, params = jax_toy_params(jconfig, seed=6)
    y = batch(seed=9)["y"]
    shape = y.shape
    model = create_model(tconfig, device="cpu")
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    task = create_task(tconfig, model)
    overrides = {}
    if approach in ("ours_DV", "ours_slowDV"):
        step = tconfig.model.reach_target_steps
        task.reconfigure(step)
        overrides = dict(zip(("sigma_min_y", "sigma_max_y"), map(float, jax_sigma_y_at_step(jconfig, step))))
        assert task.sde["y"].sigma_max == overrides["sigma_max_y"] == np.float32(tconfig.model.sigma_max_y_target)
    try:
        jsde, eps = jax_build_sde(jconfig, **overrides)
        fn = jax_pc.get_conditional_sampling_fn(jconfig, jsde, shape, eps, module, p_steps=p_steps)
        key = jax.random.key(17)
        want = np.asarray(fn(key, params, jnp.asarray(y))[0])
    finally:
        reset_jax_dispatch()
    draws = sr3_draws(key, p_steps, shape) if approach == "sr3" else jax_sampler_draws(key, p_steps, shape, False)
    noise = Replay(draws)
    got, _ = task.sampling_fn(shape, p_steps=p_steps)(noise, model, torch.from_numpy(y))
    assert not noise.draws
    assert got.shape == shape and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


# ---- what `chip_smoke.py` counts and checks on these paths ------------------


@pytest.mark.parametrize("approach", APPROACHES)
def test_chip_smoke_sites_are_the_checked_ones(approach):
    """On the meta device at full width, as `chip_smoke.py` counts them: the
    bfloat16 sampler's kernel 1-3 calls per forward are the flagship's, at
    the sites its kernel phase checks; a train step makes the flagship's
    number of kernel-4 calls, and only CDE's 3-channel output conv (forward
    96 -> 3, dx 3 -> 96) adds shapes, which the estimator phase checks
    against the plain version.  Their launch plans hold, in both types."""
    import chip_smoke
    from _torch_port_splitk import check_plan

    recipe = dict(chip_smoke.ESTIMATORS)[approach]
    config = recipe()
    config.model.fused_block = True
    calls = chip_smoke.forward_calls(config, chip_smoke.BATCH)
    assert calls == chip_smoke.flagship_block_path_calls()
    assert chip_smoke.per_name(calls) == chip_smoke.PER_FORWARD_BLOCK_PATH

    train = recipe()
    train.model.conv_dispatch = "conv3x3_kernel"
    shapes = chip_smoke.conv_call_shapes(train)
    flagship = chip_smoke.conv_call_shapes(chip_smoke.train_configs())
    per_step = tuple(sum(n for (ph, *_), n in shapes.items() if ph == p) for p in ("forward", "dx"))
    assert per_step == chip_smoke.CONV_PER_TRAIN_STEP
    new = {k: n for k, n in shapes.items() if k not in flagship}
    assert new == ({("forward", 160, 96, 3): 1, ("dx", 160, 3, 96): 1} if approach == "sr3" else {})
    for _, h, cin, cout in new:
        for dtype in (torch.float32, torch.bfloat16):
            check_plan(chip_smoke.TRAIN_BATCH * h * h, cin, cout, dtype)
