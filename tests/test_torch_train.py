"""The port's losses, train step, EMA and train-state converter against the
JAX package, on the toy `ddpm_paired` (`_torch_port_toy`: 32px, nf=32,
ch_mult (1, 2, 2)) with the same weights (`models/convert.py`), dropout 0
and batch 2; the unconditional loss on a 16px NCSN++
(`_torch_port_toy.ncsnpp_toy_config`) under VE, VP and sub-VP.

jax.random and torch.Generator cannot agree, so every JAX draw (t and the
noise of each domain, in the key chain of `losses/continuous.py:58-86`
after the step's `fold_in`) is replayed with jax.random and injected into
the port.

Tolerances:
* losses 1e-5 relative (measured ~1e-7);
* gradients 1e-4 of each tensor's largest magnitude (measured <1e-5).
  Some gradients are zero in exact arithmetic (a bias before a GroupNorm of
  one channel per group, an attention key bias): both sides return rounding
  noise there, ~2e-8 of the model's largest gradient.  A tensor whose JAX
  gradient is below NOISE_LEVEL (1e-6) of the model's largest is held at
  NOISE_LEVEL of that largest gradient instead (measured 2.4e-8);
* the optimizer (optax's clip, Adam, warmup) and the EMA on the same
  gradients: every element of params, EMA and Adam's moments after 3 steps
  at 1e-6 of its tensor's largest magnitude, no element excluded;
* the whole step, K steps: Adam's updates are ~lr*sign(g) at first and then
  follow the ratio of an element's gradients across steps, so they carry an
  element's relative gradient error, not its tensor's: an element at 1e-3
  of its tensor's largest gradient moves ~1e-2*lr apart.  So each tensor's
  update (params after K steps minus before) is held by norm at 2e-3
  (measured 4.2e-4), tensors of rounding noise aside; and every element at
  1e-6 of its tensor's largest magnitude except where its JAX gradient at
  some step was below SMALL_GRAD (1e-2) of its tensor's largest, or its
  tensor is rounding noise: those elements are counted, printed and
  asserted below 25% (measured 20.1% and 20.2% of 2,197,836 with warmup 0
  and 2);
* the EMA warmup decay exactly, and the EMA update exactly against the JAX
  function run op by op (jitted, XLA fuses it and differs by one ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_toy import (
    hold_gradients,
    jax_init_params,
    jax_loss_draws,
    jax_step_draws,
    jax_toy_params,
    ncsnpp_toy_config,
    reset_jax_dispatch,
    to_torch,
    toy_inputs,
    train_toy_configs,
)
from conditional_score_diffusion_tpu.losses import build_loss_fn as jax_build_loss_fn
from conditional_score_diffusion_tpu.models import ema as jax_ema
from conditional_score_diffusion_tpu.sde import build_sde as jax_build_sde
from conditional_score_diffusion_tpu.training import state as jax_state
from conditional_score_diffusion_tpu.training import steps as jax_steps
from conditional_score_diffusion_tpu_torch.losses import build_loss_fn
from conditional_score_diffusion_tpu_torch.models import create_model
from conditional_score_diffusion_tpu_torch.models.convert import flax_to_state_dict, load_jax_train_state
from conditional_score_diffusion_tpu_torch.models.ema import EMAState, ema_update, warmup_decay
from conditional_score_diffusion_tpu_torch.models.wrappers import get_score_fn
from conditional_score_diffusion_tpu_torch.sde import build_sde
from conditional_score_diffusion_tpu_torch.training.state import create_train_state
from conditional_score_diffusion_tpu_torch.training.steps import apply_gradients, make_eval_step, make_train_step

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-6
SMALL_GRAD = 1e-2
NOISE_LEVEL = 1e-6
UPDATE_TOL = 2e-3
KEY = jax.random.key(7)


@pytest.fixture(scope="module")
def toy():
    jconfig, _ = train_toy_configs()
    module, params = jax_toy_params(jconfig)
    x, y, _ = toy_inputs()
    return module, params, {"x": x, "y": y}


def _port_model(tconfig, params, device="cpu"):
    model = create_model(tconfig, device=device)
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return model


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max()


def test_multispeed_loss_matches_jax(toy):
    module, params, batch = toy
    jconfig, tconfig = train_toy_configs()
    jsde, _ = jax_build_sde(jconfig)
    rng = jax.random.key(3)
    try:
        want = float(jax.jit(lambda p: jax_build_loss_fn(jconfig, module, jsde, train=True)(p, jsde, batch, rng))(params))
    finally:
        reset_jax_dispatch()
    draws = jax_loss_draws(rng, {k: v.shape for k, v in batch.items()})
    model = _port_model(tconfig, params)
    loss_fn = build_loss_fn(tconfig, model, build_sde(tconfig)[0], train=True)
    t = torch.from_numpy(draws.pop("t"))
    got = loss_fn(build_sde(tconfig)[0], to_torch(batch), t=t, noise=to_torch(draws)).item()
    assert abs(got - want) <= LOSS_RTOL * abs(want), (got, want)


@pytest.mark.parametrize("likelihood_weighting", [True, False])
def test_sr3_loss_matches_jax(likelihood_weighting):
    """The SR3 branch (a single SDE: x diffused, y clean) on `ddpm_paired_SR3`."""
    jconfig, tconfig = train_toy_configs()
    for c in (jconfig, tconfig):
        c.training.conditioning_approach = "sr3"
        c.training.likelihood_weighting = likelihood_weighting
        c.model.name = "ddpm_paired_SR3"
        c.model.output_channels = 3
    module, params = jax_toy_params(jconfig, seed=2)
    x, y, _ = toy_inputs(seed=5)
    batch = {"x": x * 2.0, "y": y}
    jsde, _ = jax_build_sde(jconfig)
    rng = jax.random.key(4)
    try:
        want = float(jax.jit(lambda p: jax_build_loss_fn(jconfig, module, jsde, train=True)(p, jsde, batch, rng))(params))
    finally:
        reset_jax_dispatch()
    rng_t, rng_z, _ = jax.random.split(rng, 3)
    t = np.asarray(jax.random.uniform(rng_t, (2,), minval=1e-5, maxval=1.0))
    z = np.asarray(jax.random.normal(rng_z, x.shape))
    model = _port_model(tconfig, params)
    sde = build_sde(tconfig)[0]
    got = build_loss_fn(tconfig, model, sde, train=True)(
        sde, to_torch(batch), t=torch.from_numpy(t), noise={"x": torch.from_numpy(z)}
    ).item()
    assert abs(got - want) <= LOSS_RTOL * abs(want), (got, want)


UNCONDITIONAL = [("vesde", False), ("vesde", True), ("vpsde", False), ("subvpsde", True)]


def _unconditional_case(sde_name, likelihood_weighting):
    """A 16px NCSN++ (`_torch_port_toy.ncsnpp_toy_config`) under ``sde_name``,
    its JAX params, a batch in [0, 1] and the JAX loss's draws (t, then z:
    `losses/continuous.py`'s unconditional branch splits its key in 3)."""
    from conditional_score_diffusion_tpu.configs import base as jax_base
    from conditional_score_diffusion_tpu_torch.configs import base as torch_base

    configs = [ncsnpp_toy_config(jax_base), ncsnpp_toy_config(torch_base)]
    for c in configs:
        c.training.sde = sde_name
        c.training.likelihood_weighting = likelihood_weighting
    module, params = jax_init_params(configs[0], seed=2)
    batch = np.random.RandomState(3).rand(2, 16, 16, 3).astype(np.float32)
    rng = jax.random.key(6)
    rng_t, rng_z, _ = jax.random.split(rng, 3)
    eps = 1e-5
    t = np.asarray(jax.random.uniform(rng_t, (2,), minval=eps, maxval=1.0))
    z = np.asarray(jax.random.normal(rng_z, batch.shape))
    return configs, module, params, batch, rng, t, z


@pytest.mark.parametrize("sde_name,likelihood_weighting", UNCONDITIONAL)
def test_unconditional_loss_matches_jax(sde_name, likelihood_weighting):
    """The unconditional branch (no ``conditioning_approach``): the batch a
    bare tensor, diffused at t and scored unconditionally."""
    (jconfig, tconfig), module, params, batch, rng, t, z = _unconditional_case(sde_name, likelihood_weighting)
    jsde, _ = jax_build_sde(jconfig)
    try:
        want = float(jax.jit(lambda p: jax_build_loss_fn(jconfig, module, jsde, train=True)(p, jsde, batch, rng))(params))
    finally:
        reset_jax_dispatch()
    model = _port_model(tconfig, params)
    sde = build_sde(tconfig)[0]
    got = build_loss_fn(tconfig, model, sde, train=True)(
        sde, torch.from_numpy(batch), t=torch.from_numpy(t), noise={"x": torch.from_numpy(z)}
    ).item()
    assert abs(got - want) <= LOSS_RTOL * abs(want), (got, want)


@pytest.mark.parametrize("sde_name,likelihood_weighting", UNCONDITIONAL[:3:2])
def test_unconditional_gradients_match_jax(sde_name, likelihood_weighting):
    """Every parameter's gradient of the unconditional loss against `jax.grad`."""
    (jconfig, tconfig), module, params, batch, rng, t, z = _unconditional_case(sde_name, likelihood_weighting)
    jsde, _ = jax_build_sde(jconfig)
    try:
        grads = jax.jit(jax.grad(lambda p: jax_build_loss_fn(jconfig, module, jsde, train=True)(p, jsde, batch, rng)))(params)
    finally:
        reset_jax_dispatch()
    want = flax_to_state_dict(jax.device_get(grads))
    model = _port_model(tconfig, params)
    sde = build_sde(tconfig)[0]
    build_loss_fn(tconfig, model, sde, train=True)(
        sde, torch.from_numpy(batch), t=torch.from_numpy(t), noise={"x": torch.from_numpy(z)}
    ).backward()
    got = {n: p.grad for n, p in model.named_parameters()}
    hold_gradients({n: got[n] for n in want}, want, GRAD_TOL, NOISE_LEVEL)


def test_gradients_match_jax(toy):
    """Every parameter's gradient of the 2-key loss against `jax.grad`."""
    module, params, batch = toy
    jconfig, tconfig = train_toy_configs()
    jsde, _ = jax_build_sde(jconfig)
    rng = jax.random.key(5)
    try:
        grads = jax.jit(jax.grad(lambda p: jax_build_loss_fn(jconfig, module, jsde, train=True)(p, jsde, batch, rng)))(params)
    finally:
        reset_jax_dispatch()
    want = flax_to_state_dict(jax.device_get(grads))
    draws = jax_loss_draws(rng, {k: v.shape for k, v in batch.items()})
    model = _port_model(tconfig, params)
    sde = build_sde(tconfig)[0]
    t = torch.from_numpy(draws.pop("t"))
    build_loss_fn(tconfig, model, sde, train=True)(sde, to_torch(batch), t=t, noise=to_torch(draws)).backward()
    hold_gradients({n: p.grad for n, p in model.named_parameters()}, want, GRAD_TOL, NOISE_LEVEL)


def _jax_run(jconfig, module, params, batch, steps):
    """``steps`` JAX train steps from ``params``; the states after each and
    the gradients each step saw (for the small-gradient mask)."""
    train_step, tx = jax_steps.make_train_step(jconfig, module)
    loss_fn = jax_build_loss_fn(jconfig, module, jax_build_sde(jconfig)[0], train=True)
    sde = jax_build_sde(jconfig)[0]
    try:
        step = jax.jit(train_step)
        grad = jax.jit(lambda p, r: jax.grad(lambda q: loss_fn(q, sde, batch, r))(p))
        state = jax_state.create_train_state(jconfig, params, tx)
        states, grads, metrics = [], [], []
        for i in range(steps):
            grads.append(flax_to_state_dict(jax.device_get(grad(state.params, jax.random.fold_in(KEY, i)))))
            state, m = step(state, batch, KEY)
            states.append(jax.device_get(state))
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        reset_jax_dispatch()
    return states, grads, metrics


def _port_run(tconfig, params, batch, steps, start_step=0, state=None):
    model = _port_model(tconfig, params) if state is None else state.model
    state = state or create_train_state(tconfig, model)
    train_step = make_train_step(tconfig, model)
    metrics = []
    for i in range(start_step, start_step + steps):
        draws = jax_step_draws(KEY, i, {k: v.shape for k, v in batch.items()})
        m = train_step(state, to_torch(batch), noise=to_torch(draws))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _noise_tensors(grads: list) -> set:
    """Names whose JAX gradient is rounding noise at some step."""
    noise = set()
    for step_grads in grads:
        top = max(g.abs().max().item() for g in step_grads.values())
        noise |= {n for n, g in step_grads.items() if g.abs().max().item() < NOISE_LEVEL * top}
    return noise


def _hold_params(got: dict, want: dict, grads: list, start: dict) -> int:
    """``got`` against ``want`` (see the module docstring): each tensor's
    update from ``start`` by norm, and each element outside the small
    gradients; returns the number of elements excluded."""
    excluded = 0
    noise = _noise_tensors(grads)
    for name, w in want.items():
        w, g, p0 = w.numpy(), got[name].detach().numpy(), start[name].numpy()
        if name in noise:
            excluded += w.size
            continue
        assert np.linalg.norm((g - p0) - (w - p0)) <= UPDATE_TOL * np.linalg.norm(w - p0), name
        small = np.zeros(w.shape, bool)
        for step_grads in grads:
            gr = np.abs(step_grads[name].numpy())
            small |= gr < SMALL_GRAD * gr.max()
        excluded += int(small.sum())
        err = np.where(small, 0.0, np.abs(g - w))
        assert err.max() <= PARAM_TOL * np.abs(w).max(), (name, err.max(), np.abs(w).max())
    return excluded


@pytest.mark.parametrize("warmup", [0, 2])
def test_three_steps_match_jax(toy, warmup):
    """3 steps of Adam + warmup + clip 1.0 + EMA: params and EMA after the
    last, loss and grad_norm (before clipping) of each."""
    module, params, batch = toy
    jconfig, tconfig = train_toy_configs(warmup=warmup)
    states, grads, jmetrics = _jax_run(jconfig, module, params, batch, 3)
    state, metrics = _port_run(tconfig, params, batch, 3)
    for got, want in zip(metrics, jmetrics):
        assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
        assert abs(got["grad_norm"] - want["grad_norm"]) <= GRAD_TOL * want["grad_norm"]
    assert jmetrics[0]["grad_norm"] > 1.0  # the clip acts
    last, start = states[-1], flax_to_state_dict(params)
    excluded = _hold_params(dict(state.model.named_parameters()), flax_to_state_dict(last.params), grads, start)
    excluded += _hold_params(state.ema.params, flax_to_state_dict(last.ema.params), grads, start)
    n = 2 * sum(p.numel() for p in state.model.parameters())
    print(f"warmup {warmup}: {excluded} of {n} elements excluded")
    assert excluded <= 0.25 * n
    assert state.step == int(last.step) == 3 and state.ema.num_updates == int(last.ema.num_updates)
    if warmup:
        assert state.scheduler.get_last_lr()[0] == pytest.approx(jconfig.optim.lr)


class _Params(torch.nn.Module):
    def __init__(self, arrays):
        super().__init__()
        for k, v in arrays.items():
            self.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))


@pytest.mark.parametrize("warmup", [0, 2])
def test_optimizer_matches_optax_on_the_same_gradients(warmup):
    """optax's clip_by_global_norm -> Adam -> warmup, and the EMA, against
    the port's `apply_gradients` on the same gradients: a global norm above
    the clip, one below it, one above it again."""
    import optax

    jconfig, tconfig = train_toy_configs(warmup=warmup)
    rng = np.random.RandomState(1)
    params = {"a": (0.1 * rng.randn(64, 32)).astype(np.float32), "b": (0.1 * rng.randn(32)).astype(np.float32)}
    tx = jax_state.make_optimizer(jconfig)
    jstate = jax_state.create_train_state(jconfig, {k: jnp.asarray(v) for k, v in params.items()}, tx)
    model = _Params(params)
    state = create_train_state(tconfig, model)
    for norm in (5.0, 0.5, 3.0):
        g = {k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
        scale = norm / np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in g.values()))
        g = {k: (v * scale).astype(np.float32) for k, v in g.items()}
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate.opt_state, jstate.params)
        new = optax.apply_updates(jstate.params, updates)
        jstate = jstate.replace(step=jstate.step + 1, params=new, opt_state=opt_state,
                                ema=jax_ema.ema_update(jstate.ema, new))
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(g[k].copy())
        g_norm = apply_gradients(state, model.named_parameters())
        assert g_norm.item() == pytest.approx(norm, rel=1e-6)
    adam = jstate.opt_state[1][0]
    for k, p in model.named_parameters():
        for got, want in ((p.detach(), jstate.params[k]), (state.ema.params[k], jstate.ema.params[k]),
                          (state.optimizer.state[p]["exp_avg"], adam.mu[k]),
                          (state.optimizer.state[p]["exp_avg_sq"], adam.nu[k])):
            want = np.asarray(want)
            assert np.abs(got.numpy() - want).max() <= PARAM_TOL * np.abs(want).max(), k


def test_warmup_first_step_changes_nothing(toy):
    """optax's schedule counts from 0: the first update is taken at lr 0."""
    _, params, batch = toy
    _, tconfig = train_toy_configs(warmup=2)
    state, _ = _port_run(tconfig, params, batch, 1)
    want = flax_to_state_dict(params)
    for name, p in state.model.named_parameters():
        assert torch.equal(p.detach(), want[name]), name


def test_gradient_accumulation_matches_the_full_batch(toy):
    """``accumulate_grad_batches=2`` on the same t and noise as one batch of
    2: the same loss, gradient norm and (clipped) gradients, to float
    rounding (the gradients as `test_gradients_match_jax` holds them)."""
    _, params, batch = toy
    results = []
    for accum in (1, 2):
        _, tconfig = train_toy_configs()
        tconfig.training.accumulate_grad_batches = accum
        state, metrics = _port_run(tconfig, params, batch, 1)
        results.append(({n: p.grad for n, p in state.model.named_parameters()}, metrics[0]))
    (g1, m1), (g2, m2) = results
    assert m2["loss"] == pytest.approx(m1["loss"], rel=LOSS_RTOL)
    assert m2["grad_norm"] == pytest.approx(m1["grad_norm"], rel=GRAD_TOL)
    hold_gradients(g2, g1, GRAD_TOL, NOISE_LEVEL)


def _jax_state_pieces(state):
    adam, schedule = state.opt_state[1]
    return {
        "step": int(state.step),
        "params": state.params,
        "ema": {"decay": state.ema.decay, "num_updates": state.ema.num_updates, "params": state.ema.params},
        "adam": {"count": adam.count, "mu": adam.mu, "nu": adam.nu},
        "schedule_count": int(schedule.count),
    }


def test_converted_state_continues_like_jax(toy):
    """A JAX state after 2 steps, converted (params, EMA, Adam's moments and
    count, the schedule, the step), then one more step on each side."""
    module, params, batch = toy
    jconfig, tconfig = train_toy_configs(warmup=2)
    states, grads, _ = _jax_run(jconfig, module, params, batch, 3)
    model = _port_model(tconfig, params)
    state = create_train_state(tconfig, model)
    load_jax_train_state(state, _jax_state_pieces(states[1]))
    assert state.step == 2 and state.scheduler.get_last_lr()[0] == pytest.approx(jconfig.optim.lr)
    state, _ = _port_run(tconfig, params, batch, 1, start_step=2, state=state)
    last, start = states[2], flax_to_state_dict(states[1].params)
    _hold_params(dict(state.model.named_parameters()), flax_to_state_dict(last.params), grads[2:], start)
    _hold_params(state.ema.params, flax_to_state_dict(last.ema.params), grads[2:], flax_to_state_dict(states[1].ema.params))
    adam = last.opt_state[1][0]
    mu, nu = flax_to_state_dict(adam.mu), flax_to_state_dict(adam.nu)
    noise = _noise_tensors(grads)
    for name, p in state.model.named_parameters():
        s = state.optimizer.state[p]
        assert int(s["step"]) == int(adam.count) == 3
        if name not in noise:
            assert _rel(s["exp_avg"].numpy(), mu[name].numpy()) <= GRAD_TOL, name
            assert _rel(s["exp_avg_sq"].numpy(), nu[name].numpy()) <= GRAD_TOL, name


def test_eval_step_on_ema_matches_jax(toy):
    """The eval loss (train=False: no dropout key in the chain) on the EMA
    weights of a state, against JAX `make_eval_step`."""
    module, params, batch = toy
    jconfig, tconfig = train_toy_configs()
    rng = jax.random.key(9)
    shifted = jax.tree.map(lambda p: p * 0.5, params)
    tx = jax_state.make_optimizer(jconfig)
    jstate = jax_state.create_train_state(jconfig, params, tx)
    jstate = jstate.replace(ema=jstate.ema.replace(params=shifted))
    try:
        want = float(jax.jit(jax_steps.make_eval_step(jconfig, module))(jstate, batch, rng)["eval_loss"])
    finally:
        reset_jax_dispatch()
    model = _port_model(tconfig, params)
    state = create_train_state(tconfig, model)
    for name, v in flax_to_state_dict(shifted).items():
        state.ema.params[name].copy_(v)
    draws = jax_loss_draws(rng, {k: v.shape for k, v in batch.items()}, train=False)
    got = make_eval_step(tconfig, model)(state, to_torch(batch), noise=to_torch(draws))["eval_loss"].item()
    assert abs(got - want) <= LOSS_RTOL * abs(want), (got, want)
    assert model.training is False  # create_model's mode, left as it was


def test_ema_matches_jax():
    """The warmup decay of 30 updates exactly, and the shadow after them."""
    rng = np.random.RandomState(0)
    p0 = {"a": rng.randn(5, 3).astype(np.float32), "b": rng.randn(7).astype(np.float32)}
    jema = jax_ema.EMAState.create({k: jnp.asarray(v) for k, v in p0.items()}, decay=0.999)
    ema = EMAState.create(((k, torch.from_numpy(v)) for k, v in p0.items()), decay=0.999)
    for i in range(30):
        n = jema.num_updates + 1
        want_decay = np.float32(jnp.minimum(jema.decay, (1.0 + n) / (10.0 + n)))
        assert warmup_decay(ema.decay, ema.num_updates) == want_decay
        new = {k: rng.randn(*v.shape).astype(np.float32) for k, v in p0.items()}
        jema = jax_ema.ema_update(jema, {k: jnp.asarray(v) for k, v in new.items()})
        ema_update(ema, ((k, torch.from_numpy(v)) for k, v in new.items()))
    assert ema.num_updates == int(jema.num_updates) == 30
    for k in p0:
        np.testing.assert_array_equal(ema.params[k].numpy(), np.asarray(jema.params[k]))


def test_eval_score_leaves_a_training_module_in_train_mode():
    """`get_score_fn(train=False)` on a module in train mode: the module stays
    in train mode after each call, and its dropout still acts."""
    _, tconfig = train_toy_configs(dropout=0.5)
    model = create_model(tconfig, device="cpu").train()
    x, y, t = (torch.from_numpy(a) for a in toy_inputs())
    score = get_score_fn(build_sde(tconfig)[0], model, conditional=True, train=False, continuous=True)
    with torch.no_grad():
        score({"x": x, "y": y}, t)
    assert model.training
    assert all(m.training for m in model.modules())
    drop = next(m for m in model.modules() if isinstance(m, torch.nn.Dropout))
    h = torch.ones(1000)
    assert (drop(h) == 0).any() and drop.training
