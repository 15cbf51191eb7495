"""The NCSN++ train step of the DF2K direct 4x recipe (``ncsnpp_KxSR``
under ``conditional_decreasing_variance``) in the port against the JAX
package, at 32px (x 32x32, y 8x8; `tests/test_torch_ncsnpp.py:kxsr_config`),
batch 2, dropout 0, the sigma_y anneal cut to 2 steps so it moves over the
three steps taken:

* three whole train steps on the JAX key chain's t and noise: each loss
  (1e-5 relative), each parameter and EMA tensor after them (1e-4 of the
  tensor's largest magnitude), sigma_y at each step, and the Fourier
  projection's ``W`` (a buffer here, a ``stop_gradient`` parameter in JAX)
  unchanged on both sides;
* a checkpoint round trip: a state saved after two steps and restored into
  a fresh one takes the third step bit for bit as the one never saved;
* a JAX train state after two steps carried over by
  `models/convert.py:load_jax_train_state` (params, EMA, Adam's moments,
  the schedule, the step; ``W`` in JAX's EMA and its zero moments) takes
  the third step as JAX does;
* `Trainer.fit` on the recipe over a small LRHR fixture, with its ``KxSR``
  callback.
"""

import collections
import os
import pickle

import jax
import numpy as np
import torch

from _torch_port_toy import jax_loss_draws, reset_jax_dispatch, to_torch
from test_torch_ncsnpp import jax_params, kxsr_config
from conditional_score_diffusion_tpu.configs.srflow import df2k_config as jax_df2k_config
from conditional_score_diffusion_tpu.training import state as jax_state
from conditional_score_diffusion_tpu.training import steps as jax_steps
from conditional_score_diffusion_tpu.training.schedules import sigma_y_at_step as jax_sigma_y_at_step
from conditional_score_diffusion_tpu_torch.configs import df2k_config
from conditional_score_diffusion_tpu_torch.models import create_model
from conditional_score_diffusion_tpu_torch.models.convert import flax_to_state_dict, load_jax_train_state
from conditional_score_diffusion_tpu_torch.training.checkpoint import CheckpointManager
from conditional_score_diffusion_tpu_torch.training.schedules import sigma_y_at_step
from conditional_score_diffusion_tpu_torch.training.state import create_train_state
from conditional_score_diffusion_tpu_torch.training.steps import make_train_step
from conditional_score_diffusion_tpu_torch.training.trainer import Trainer, read_scalars

torch.set_num_threads(1)

KEY = jax.random.key(31)
STEPS = 3
LOSS_RTOL, PARAM_TOL = 1e-5, 1e-4
W_NAME = "unet.fourier.W"


def _configs():
    """The JAX and port recipes.  The JAX recipe names no
    ``conditioning_approach``, which JAX's loss factory keys the conditional
    branch on (`losses/factory.py`), so JAX's step would take the
    unconditional branch with a dict batch and fail; the JAX side is given
    the recipe's approach, VS-CMDE (``ours_DV``), and the port's recipe
    stays as it is (its loss follows the conditional task)."""
    configs = []
    for df2k in (jax_df2k_config, df2k_config):
        c = kxsr_config(df2k)
        if df2k is jax_df2k_config:
            c.training.conditioning_approach = "ours_DV"
        c.model.dropout = 0.0
        c.model.reach_target_steps = 2
        c.training.batch_size = 2
        c.optim.warmup = 0
        configs.append(c)
    return configs


def _batch():
    rng = np.random.RandomState(12)
    return {"x": rng.rand(2, 32, 32, 3).astype(np.float32), "y": rng.rand(2, 8, 8, 3).astype(np.float32)}


def _draws(step, batch):
    return jax_loss_draws(jax.random.fold_in(KEY, step), {k: v.shape for k, v in batch.items()})


def _jax_states(jconfig, module, params, batch):
    """The JAX states after each of the three steps and their metrics."""
    train_step, tx = jax_steps.make_train_step(jconfig, module)
    try:
        step = jax.jit(train_step)
        state = jax_state.create_train_state(jconfig, params, tx)
        states, metrics = [], []
        for _ in range(STEPS):
            state, m = step(state, batch, KEY)
            states.append(state)
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        reset_jax_dispatch()
    return states, metrics


_CACHE = {}


def _jax_run():
    if not _CACHE:
        jconfig, tconfig = _configs()
        module, params = jax_params(jconfig)
        batch = _batch()
        _CACHE.update(tconfig=tconfig, jconfig=jconfig, params=params, batch=batch,
                      run=_jax_states(jconfig, module, params, batch))
    return _CACHE


def _port_state(tconfig, params):
    model = create_model(tconfig, device="cpu").train()
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return create_train_state(tconfig, model)


def _hold(got, want_tree, what):
    want = {n: w for n, w in flax_to_state_dict(jax.device_get(want_tree)).items() if n in got}
    assert want.keys() == got.keys()
    for name, w in want.items():
        err = (got[name].detach() - w).abs().max().item()
        assert err <= PARAM_TOL * w.abs().max().item(), (what, name, err)


def test_train_steps_match_jax():
    run = _jax_run()
    tconfig, jconfig, params, batch = run["tconfig"], run["jconfig"], run["params"], run["batch"]
    states, metrics = run["run"]
    state = _port_state(tconfig, params)
    w0 = state.model.unet.fourier.W.clone()
    port_step = make_train_step(tconfig, state.model)
    for i in range(STEPS):
        m = port_step(state, to_torch(batch), noise=to_torch(_draws(i, batch)))
        assert abs(float(m["loss"]) - metrics[i]["loss"]) <= LOSS_RTOL * abs(metrics[i]["loss"]), i
        assert sigma_y_at_step(tconfig, i) == tuple(float(v) for v in jax_sigma_y_at_step(jconfig, i))
    smax = [sigma_y_at_step(tconfig, s)[1] for s in range(STEPS)]
    assert smax[0] > smax[1] > smax[2]  # start, middle and the target (float32 rounding of each)
    assert np.allclose([smax[0], smax[2]], [tconfig.model.sigma_max_y, tconfig.model.sigma_max_y_target], rtol=1e-6)
    last = states[-1]
    _hold(dict(state.model.named_parameters()), last.params, "params")
    _hold(state.ema.params, last.ema.params, "ema")
    assert torch.equal(state.model.unet.fourier.W, w0)  # the buffer stays as it was
    for tree in (last.params, last.ema.params):  # and JAX's parameter too (stop_gradient, no weight decay)
        assert torch.equal(flax_to_state_dict(jax.device_get(tree))[W_NAME], w0)
    assert W_NAME not in state.ema.params and W_NAME in state.model.state_dict()


def test_checkpoint_round_trip_continues_exactly(tmp_path):
    run = _jax_run()
    tconfig, params, batch = run["tconfig"], run["params"], run["batch"]
    a = _port_state(tconfig, params)
    step_a = make_train_step(tconfig, a.model)
    for i in range(2):
        step_a(a, to_torch(batch), noise=to_torch(_draws(i, batch)))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(a.step, a)
    b = _port_state(tconfig, params)
    with torch.no_grad():
        b.model.unet.fourier.W.mul_(2.0)  # restored from the file, not kept from the build
    mgr.restore(b)
    assert b.step == 2 and b.ema.num_updates == 2 and torch.equal(b.model.unet.fourier.W, a.model.unet.fourier.W)
    step_b = make_train_step(tconfig, b.model)
    for state, step in ((a, step_a), (b, step_b)):
        step(state, to_torch(batch), noise=to_torch(_draws(2, batch)))
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(a.ema.params[name], b.ema.params[name]), name
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a.optimizer.state[p][k], b.optimizer.state[q][k]), (name, k)


def test_converted_jax_state_continues_like_jax():
    run = _jax_run()
    tconfig, params, batch = run["tconfig"], run["params"], run["batch"]
    states, metrics = run["run"]
    adam, schedule = states[1].opt_state[1]
    pieces = {
        "step": int(states[1].step),
        "params": states[1].params,
        "ema": {"decay": states[1].ema.decay, "num_updates": states[1].ema.num_updates, "params": states[1].ema.params},
        "adam": {"count": adam.count, "mu": adam.mu, "nu": adam.nu},
        "schedule_count": int(schedule.count),
    }
    state = _port_state(tconfig, params)
    with torch.no_grad():
        state.model.unet.fourier.W.zero_()  # the converted params entry sets it
    load_jax_train_state(state, jax.device_get(pieces))
    assert state.step == 2 and int(state.optimizer.state[next(state.model.parameters())]["step"]) == 2
    m = make_train_step(tconfig, state.model)(state, to_torch(batch), noise=to_torch(_draws(2, batch)))
    assert abs(float(m["loss"]) - metrics[2]["loss"]) <= LOSS_RTOL * abs(metrics[2]["loss"])
    _hold(dict(state.model.named_parameters()), states[2].params, "params")
    _hold(state.ema.params, states[2].ema.params, "ema")
    assert torch.equal(state.model.unet.fourier.W, flax_to_state_dict(jax.device_get(params))[W_NAME])


def _write_lrhr(directory, name, n, size, scale):
    rng = np.random.RandomState(0)
    gt = [rng.randint(0, 255, (size, size, 3), dtype=np.uint8) for _ in range(n)]
    lq = [im[::scale, ::scale].copy() for im in gt]
    os.makedirs(directory, exist_ok=True)
    for suffix, images in (("", gt), (f"_X{scale}", lq)):
        with open(os.path.join(directory, f"{name}{suffix}.pklv4"), "wb") as f:
            pickle.dump(images, f)


def test_fit_on_the_recipe_with_its_callback(tmp_path):
    """`Trainer.fit(2)` on the 32px recipe over an LRHR fixture (train and
    test splits; the eval split is ``eval.loss_split``): finite losses,
    sigma_y logged as scheduled, a checkpoint, and the ``KxSR`` callback's
    grid (2 sampler steps) with no failure; ``W`` unchanged."""
    _, config = _configs()
    data = tmp_path / "data"
    for phase, n in (("train", 4), ("test", 4)):
        _write_lrhr(data / "fixture", f"fixture-{phase}", n, 32, 4)
    config.data.dataset, config.data.base_dir = "fixture", str(data)
    config.eval.loss_split, config.eval.batch_size, config.eval.max_val_batches = "test", 2, 1
    config.training.log_freq, config.training.eval_freq, config.training.snapshot_freq = 1, 2, 2
    config.training.visualization_p_steps = 2
    trainer = Trainer(config, str(tmp_path / "logs"), device="cpu")
    w0 = trainer.model.unet.fourier.W.clone()
    history = trainer.fit(max_steps=2)
    assert trainer.callback_failures == {}
    assert all(np.isfinite(v) for _, v in history["train_loss"] + history["eval_loss"])
    assert torch.equal(trainer.model.unet.fourier.W, w0)
    scalars = read_scalars(str(tmp_path / "logs" / "scalars.jsonl"))
    assert [(s, v) for t, v, s in scalars if t == "sigma_max_y"] == [(s, sigma_y_at_step(config, s)[1]) for s in (1, 2)]
    assert trainer.ckpt.all_steps() == [2]
    assert os.listdir(tmp_path / "logs" / "images" / "KxSR_samples") == ["2.png"]


def test_plain_fir_calls_of_a_train_step_are_recorded(monkeypatch):
    """`profile_train_step.recording_upfirdn` sees every plain FIR call of a
    train step (on the CPU every FIR call is plain; the raw input's pyramid
    carries no gradient, the network's resamplings do), and `plain_fir_ms`
    times one pass that makes each call as often as the step did."""
    from conditional_score_diffusion_tpu_torch.ops import upfirdn
    from conditional_score_diffusion_tpu_torch.profile_train_step import plain_fir_ms, recording_upfirdn

    run = _jax_run()
    state = _port_state(run["tconfig"], run["params"])
    step = make_train_step(run["tconfig"], state.model)
    with recording_upfirdn() as calls:
        step(state, to_torch(run["batch"]), noise=to_torch(_draws(0, run["batch"])))
    flows = {grad for (*_, grad) in calls}
    assert flows == {True, False} and sum(calls.values()) == 12  # ch_mult (1, 2, 2): 3 levels
    made = []
    real = upfirdn.upfirdn2d
    monkeypatch.setattr(upfirdn, "upfirdn2d", lambda *a, **k: (made.append(tuple(a[0].shape)), real(*a, **k))[1])
    assert plain_fir_ms(calls, lambda fn: (made.clear(), fn(), 1.5)[2], torch.device("cpu")) == 1.5
    # one pass: each recorded call as many times as the step made it
    want = collections.Counter()
    for (shape, *_), n in calls.items():
        want[shape] += n
    assert collections.Counter(made) == want
