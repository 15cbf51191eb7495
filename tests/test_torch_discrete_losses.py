"""The port's discrete losses (`losses/discrete.py`), their factory branch
and the discrete train step against the JAX package's, on the same weights
and JAX's draws.

jax.random and torch.Generator cannot agree, so the JAX loss's draws are
replayed with jax.random and injected into the port (``labels=`` and
``noise=``): SMLD and DDPM split the key in 3 (labels, noise, dropout), the
inverse problem in 4 (labels, x's noise, y's noise, dropout).

* SMLD on `ncsnv2_64` (nf 8, 32px) under the cifar10_124 ladder (232
  levels to sigma 50) and on the conditional ``ncsn`` (nf 8, 32px, the v1
  ladder: classes 0 and 1), DDPM on the 16px DDPM toy under the discrete
  VP SDE, the inverse-problem SMLD on the 32px ``ddpm_paired`` toy under
  the multi-speed VE SDE, with and without likelihood weighting: losses at
  1e-5 relative, every parameter's gradient against `jax.grad` at 1e-4 of
  its tensor's largest magnitude (`_torch_port_toy.hold_gradients`).
* The factory: a dict SDE -> inverse-problem SMLD, VESDE -> SMLD (without
  likelihood weighting, as JAX calls it), VPSDE -> DDPM, sub-VP ->
  JAX's ValueError; the continuous branch stays.
* One train step of the legacy recipe (`ncsn_config('cifar10', 'v1')`:
  Adam lr 1e-3, eps 1e-8, no warmup, no clip, EMA rate 0) against JAX's:
  loss and grad_norm 1e-5, each tensor's update by norm at 2e-3 (Adam's
  first update is lr * g / (|g| + eps): an element's relative gradient
  error, not its tensor's), the EMA equal to the parameters.
* `VPSDE.sqrt_alphas_cumprod`: JAX's expression on the port's ladder
  exactly, JAX's values at 1e-6 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_toy import (
    hold_gradients,
    jax_toy_params,
    reset_jax_dispatch,
    to_torch,
    toy_inputs,
    train_toy_configs,
    unconditional_toy_pair,
)
from test_torch_ncsnv2 import jax_config, ncsn_params, port_config
from conditional_score_diffusion_tpu.configs import ncsn_legacy as jax_legacy
from conditional_score_diffusion_tpu.losses import build_loss_fn as jax_build_loss_fn
from conditional_score_diffusion_tpu.models import init_model_shapes_only
from conditional_score_diffusion_tpu.sde import VPSDE as JaxVPSDE
from conditional_score_diffusion_tpu.sde import build_sde as jax_build_sde
from conditional_score_diffusion_tpu.training import state as jax_state
from conditional_score_diffusion_tpu.training import steps as jax_steps
from conditional_score_diffusion_tpu_torch.losses import build_loss_fn, discrete
from conditional_score_diffusion_tpu_torch.losses.continuous import get_general_sde_loss_fn
from conditional_score_diffusion_tpu_torch.models import create_model
from conditional_score_diffusion_tpu_torch.models.convert import flax_to_state_dict
from conditional_score_diffusion_tpu_torch.sde import VESDE, VPSDE, build_sde, subVPSDE
from conditional_score_diffusion_tpu_torch.training.state import create_train_state
from conditional_score_diffusion_tpu_torch.training.steps import make_eval_step, make_train_step

torch.set_num_threads(2)

LOSS_RTOL, GRAD_TOL, NOISE_LEVEL, UPDATE_TOL = 1e-5, 1e-4, 1e-6, 2e-3
KEY = jax.random.key(11)


def jax_draws(rng, shape, n_keys=3, domains=("x",), N=1000):
    """The discrete loss's draws: labels, then one normal per domain."""
    keys = jax.random.split(rng, n_keys)
    B = shape[0]
    out = {"labels": np.asarray(jax.random.randint(keys[0], (B,), 0, N))}
    for k, d in zip(keys[1:], domains):
        out[d] = np.asarray(jax.random.normal(k, shape))
    return out


def _torch_draws(draws):
    out = to_torch({k: v for k, v in draws.items() if k != "labels"})
    return torch.from_numpy(draws["labels"]).long(), out


@functools.lru_cache(maxsize=None)
def smld_pair(name, variant):
    """(JAX config, port config, module, params, port model): ``name`` at nf 8,
    32px, on the ncsn recipe ``variant``'s ladder."""
    jconfig = jax_config(name, 32, nf=8)
    ladder = jax_legacy.ncsn_config("cifar10", variant)
    jconfig.model.sigma_max, jconfig.model.num_scales = ladder.model.sigma_max, ladder.model.num_scales
    jconfig.training.continuous = False
    module, params = init_model_shapes_only(jconfig, jax.random.key(0))
    params = ncsn_params(jax.device_get(params))
    tconfig = port_config(jconfig)
    model = create_model(tconfig, device="cpu")
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return jconfig, tconfig, module, params, model


def _batch(shape, seed=4):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _jax_value_and_grad(jconfig, module, params, batch, rng, train=True):
    jsde = jax_build_sde(jconfig)[0]
    loss_fn = jax_build_loss_fn(jconfig, module, jsde, train=train)
    try:
        loss, grads = jax.jit(jax.value_and_grad(lambda p: loss_fn(p, jsde, batch, rng)))(params)
    finally:
        reset_jax_dispatch()
    return float(loss), flax_to_state_dict(jax.device_get(grads))


def _port_value_and_grad(tconfig, model, batch, labels, noise, train=True):
    sde = build_sde(tconfig)[0]
    model.zero_grad(set_to_none=True)
    loss = build_loss_fn(tconfig, model, sde, train=train)(sde, batch, labels=labels, noise=noise)
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("name,variant", [("ncsnv2_64", "124"), ("ncsn", "v1")])
def test_smld_loss_and_gradients_match_jax(name, variant):
    jconfig, tconfig, module, params, model = smld_pair(name, variant)
    batch = _batch((2, 32, 32, 3))
    rng = jax.random.key(3)
    want_loss, want_grads = _jax_value_and_grad(jconfig, module, params, jnp.asarray(batch), rng)
    labels, noise = _torch_draws(jax_draws(rng, batch.shape, N=jconfig.model.num_scales))
    loss, grads = _port_value_and_grad(tconfig, model, torch.from_numpy(batch), labels, noise)
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss), (loss, want_loss)
    hold_gradients(grads, want_grads, GRAD_TOL, NOISE_LEVEL)


@pytest.mark.parametrize("reduce_mean", [False, True])
def test_smld_loss_reductions_match_jax(reduce_mean):
    """The loss alone (no gradient), both reductions, eval mode."""
    jconfig, tconfig, module, params, model = smld_pair("ncsnv2_64", "124")
    jconfig, tconfig = jconfig.copy_and_resolve_references(), port_config(jconfig)
    jconfig.training.reduce_mean = tconfig.training.reduce_mean = reduce_mean
    batch = _batch((3, 32, 32, 3), seed=5)
    rng = jax.random.key(8)
    jsde = jax_build_sde(jconfig)[0]
    want = float(jax.jit(lambda p: jax_build_loss_fn(jconfig, module, jsde, train=False)(p, jsde, jnp.asarray(batch), rng))(params))
    labels, noise = _torch_draws(jax_draws(rng, batch.shape, N=jconfig.model.num_scales))
    sde = build_sde(tconfig)[0]
    with torch.no_grad():
        got = build_loss_fn(tconfig, model, sde, train=False)(sde, torch.from_numpy(batch), labels=labels, noise=noise)
    assert abs(got.item() - want) <= LOSS_RTOL * abs(want)


@functools.lru_cache(maxsize=None)
def ddpm_pair():
    jconfig, tconfig, module, params, model = unconditional_toy_pair("ddpm", "vpsde")
    for c in (jconfig, tconfig):
        c.training.continuous = False
    return jconfig, tconfig, module, params, model


def test_ddpm_loss_and_gradients_match_jax():
    jconfig, tconfig, module, params, model = ddpm_pair()
    batch = _batch((2, 16, 16, 3), seed=6) * 2 - 1
    rng = jax.random.key(4)
    want_loss, want_grads = _jax_value_and_grad(jconfig, module, params, jnp.asarray(batch), rng)
    labels, noise = _torch_draws(jax_draws(rng, batch.shape, N=jconfig.model.num_scales))
    loss, grads = _port_value_and_grad(tconfig, model, torch.from_numpy(batch), labels, noise)
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss), (loss, want_loss)
    hold_gradients(grads, want_grads, GRAD_TOL, NOISE_LEVEL)


@functools.lru_cache(maxsize=None)
def paired_toy():
    jconfig, tconfig = train_toy_configs()
    module, params = jax_toy_params(jconfig)
    x, y, _ = toy_inputs()
    model = create_model(tconfig, device="cpu")
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return module, params, model, {"x": x, "y": y}


@pytest.mark.parametrize("likelihood_weighting", [True, False])
def test_inverse_problem_smld_matches_jax(likelihood_weighting):
    module, params, model, batch = paired_toy()
    jconfig, tconfig = train_toy_configs()
    for c in (jconfig, tconfig):
        c.training.continuous = False
        c.training.likelihood_weighting = likelihood_weighting
    rng = jax.random.key(9)
    want_loss, want_grads = _jax_value_and_grad(jconfig, module, params, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    draws = jax_draws(rng, batch["x"].shape, n_keys=4, domains=("x", "y"), N=jconfig.model.num_scales)
    labels, noise = _torch_draws(draws)
    loss, grads = _port_value_and_grad(tconfig, model, to_torch(batch), labels, noise)
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss), (loss, want_loss)
    hold_gradients(grads, want_grads, GRAD_TOL, NOISE_LEVEL)


def test_factory_dispatch_matches_jax():
    """Each SDE kind takes JAX's discrete branch; sub-VP raises JAX's
    message; the continuous branch is unchanged."""
    _, tconfig, _, _, model = smld_pair("ncsnv2_64", "124")
    config = port_config(jax_config("ncsnv2_64", 32, nf=8))
    config.training.continuous = False
    names = {
        "multi-speed": (dict(x=VESDE(), y=VESDE()), "get_inverse_problem_smld_loss_fn"),
        "VESDE": (VESDE(), "get_smld_loss_fn"),
        "VPSDE": (VPSDE(), "get_ddpm_loss_fn"),
    }
    for label, (sde, fn) in names.items():
        assert build_loss_fn(config, model, sde, train=True).__qualname__.startswith(fn), label
    with pytest.raises(ValueError, match="Discrete training for subVPSDE is not supported."):
        build_loss_fn(config, model, subVPSDE(), train=True)
    config.training.continuous = True
    assert build_loss_fn(config, model, VESDE(), train=True).__qualname__.startswith(get_general_sde_loss_fn.__name__)


def test_smld_is_called_without_likelihood_weighting(monkeypatch):
    """JAX passes the recipe's likelihood_weighting to the inverse-problem
    SMLD only; the single-VE SMLD keeps its default (off)."""
    seen = {}
    monkeypatch.setattr(discrete, "get_smld_loss_fn", lambda model, **kw: seen.update(kw))
    from conditional_score_diffusion_tpu_torch.losses import factory

    monkeypatch.setattr(factory, "get_smld_loss_fn", discrete.get_smld_loss_fn)
    config = port_config(jax_config("ncsnv2_64", 32, nf=8))
    config.training.continuous, config.training.likelihood_weighting = False, True
    factory.build_loss_fn(config, None, VESDE(), train=True)
    assert seen == {"train": True, "reduce_mean": config.training.reduce_mean}


def test_sqrt_alphas_cumprod_matches_jax():
    """JAX's expression on the port's ladder, exactly; against JAX's values
    at 1e-6 relative.  The ladders themselves are not JAX's bit for bit:
    XLA's CPU linspace and cumulative product round otherwise than torch's
    (up to 2.4e-7 apart in ``alphas_cumprod``; `test_torch_vp.py` holds them
    at 1e-5)."""
    sde = VPSDE(0.1, 20.0, 1000)
    got = sde.sqrt_alphas_cumprod("cpu")
    assert torch.equal(got, torch.sqrt(sde.alphas_cumprod("cpu")))
    want = np.asarray(JaxVPSDE(0.1, 20.0, 1000).sqrt_alphas_cumprod)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_legacy_train_step_matches_jax():
    """One step of the NCSN v1 recipe's train step (SMLD, legacy Adam, no
    clip, no warmup, EMA rate 0) on the same batch and draws."""
    jconfig = jax_legacy.ncsn_config("cifar10", "v1")
    jconfig.model.nf = 8
    jconfig.data.image_size = jconfig.data.effective_image_size = 32
    jconfig.training.batch_size = 2
    assert (jconfig.optim.warmup, jconfig.optim.grad_clip, jconfig.model.ema_rate) == (0, -1.0, 0.0)
    module, params = init_model_shapes_only(jconfig, jax.random.key(0))
    params = ncsn_params(jax.device_get(params))
    batch = _batch((2, 32, 32, 3), seed=7)
    train_step, tx = jax_steps.make_train_step(jconfig, module)
    try:
        state, metrics = jax.jit(train_step)(jax_state.create_train_state(jconfig, params, tx), jnp.asarray(batch), KEY)
    finally:
        reset_jax_dispatch()
    state = jax.device_get(state)

    tconfig = port_config(jconfig)
    model = create_model(tconfig, device="cpu")
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    tstate = create_train_state(tconfig, model)
    draws = jax_draws(jax.random.fold_in(KEY, 0), batch.shape, N=jconfig.model.num_scales)
    got = make_train_step(tconfig, model)(tstate, torch.from_numpy(batch), noise=to_torch(draws))
    assert abs(got["loss"].item() - float(metrics["loss"])) <= LOSS_RTOL * abs(float(metrics["loss"]))
    assert abs(got["grad_norm"].item() - float(metrics["grad_norm"])) <= LOSS_RTOL * float(metrics["grad_norm"])
    want, start = flax_to_state_dict(state.params), flax_to_state_dict(params)
    for name, p in model.named_parameters():
        w, p0 = want[name].numpy(), start[name].numpy()
        assert np.linalg.norm(p.detach().numpy() - w) <= UPDATE_TOL * np.linalg.norm(w - p0), name
    # EMA rate 0: the shadow is the parameters after the step
    for name, p in model.named_parameters():
        torch.testing.assert_close(tstate.ema.params[name], p.detach(), rtol=0, atol=1e-7 * p.abs().max().item())
    assert tstate.step == int(state.step) == 1 and tstate.optimizer.param_groups[0]["lr"] == jconfig.optim.lr


def test_discrete_eval_step_on_ema():
    """The eval step takes injected labels too and reads the EMA weights."""
    _, tconfig, _, _, model = smld_pair("ncsnv2_64", "124")
    state = create_train_state(tconfig, model)
    batch = torch.from_numpy(_batch((2, 32, 32, 3), seed=8))
    labels, noise = _torch_draws(jax_draws(jax.random.key(2), tuple(batch.shape), N=tconfig.model.num_scales))
    got = make_eval_step(tconfig, model)(state, batch, noise={"labels": labels, **noise})["eval_loss"]
    sde = build_sde(tconfig)[0]
    with torch.no_grad():
        want = build_loss_fn(tconfig, model, sde, train=False)(sde, batch, labels=labels, noise=noise)
    assert torch.equal(got, want)
