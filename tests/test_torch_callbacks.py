"""The port's training callbacks against the JAX package's.

* The registry holds exactly JAX's names, and `get_callbacks` builds JAX's
  list (the same factories, frequencies and markers) for every recipe of
  the port.
* Each visualization callback runs at toy size (8-32 px, 3 sampler steps
  through ``training.visualization_p_steps``) on the same weights in both
  packages, the port fed the JAX key chain's draws through the trainer's
  ``callback_noise`` hook: every array the port hands its writer equals the
  one the JAX callback hands a recording stand-in writer, set on a stub
  trainer, at 1e-4 of its largest magnitude (images in [0, 1]; the 2-D
  scatter's points; the score-norm curve).  ``paired3D`` runs in both
  packages on a stub task whose sampler returns the same volumes (the
  frames and the scalar): JAX's callback cannot run on the 3-D recipe,
  whose ``data.shape_x`` has four entries where its ``_xshape`` unpacks
  three (ROADMAP.md section 3); `test_torch_ddpm3d.py` runs the port's on
  the 3-D model.
* `_FreqGated` fires at the same steps.
* A callback that fails half way through its sampler is counted, logged as
  JAX logs it, and leaves the model's parameters, train mode, the EMA and
  Adam's state bit for bit as they were.
"""

import copy
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_toy import Replay, jax_sampler_draws, jax_unconditional_draws, randomize_params, reset_jax_dispatch
from test_torch_multiscale import port_config
from conditional_score_diffusion_tpu import registry as jax_registry
from conditional_score_diffusion_tpu.configs import base as jax_base
from conditional_score_diffusion_tpu.models import init_model
from conditional_score_diffusion_tpu.training import callbacks as jax_callbacks
from conditional_score_diffusion_tpu.training import tasks as jax_tasks
from conditional_score_diffusion_tpu_torch import configs as port_configs
from conditional_score_diffusion_tpu_torch import registry
from conditional_score_diffusion_tpu_torch.configs import Config, celeba_sr_160_config, hq160_sequential_config
from conditional_score_diffusion_tpu_torch.models import create_model
from conditional_score_diffusion_tpu_torch.models.convert import flax_to_state_dict
from conditional_score_diffusion_tpu_torch.training import callbacks, tasks
from conditional_score_diffusion_tpu_torch.training.trainer import Trainer, read_scalars

torch.set_num_threads(1)

STEP = 6  # the step the callbacks fire at (visualization_freq 3)
P_STEPS = 3
TOL = 1e-4


# ---- the registry and get_callbacks -----------------------------------------


def test_registry_names_are_jaxs():
    assert list(registry.callbacks.names()) == list(jax_registry.callbacks.names())


def _port_recipes():
    """Every recipe of the port that trains: each recipe function of
    `configs` that takes no argument, the CelebA recipes for each approach
    and the sequential scales (master configs hold no ``training``)."""
    out = {}
    for name in port_configs.__all__:
        fn = getattr(port_configs, name)
        if not name.endswith("_config") or name in ("base_config", "image_model_defaults"):
            continue
        try:
            config = fn()
        except TypeError:
            continue
        if "training" in config:
            out[name] = config
    for approach in ("ours_NDV", "ours_DV", "ours_slowDV", "song", "sr3"):
        out[f"celeba_sr_160_{approach}"] = celeba_sr_160_config(approach)
    for size in (40, 80, 160):
        for space in ("haar", "bicubic"):
            out[f"hq160_sequential_{size}_{space}"] = hq160_sequential_config(size, space)
    return out


def _signature(cb):
    fn = cb.fn if hasattr(cb, "fn") else cb
    return type(cb).__name__, getattr(cb, "freq", None), fn.__qualname__


def test_get_callbacks_is_jaxs_for_every_recipe():
    """The JAX `get_callbacks` reads a recipe through ``.get`` and ``in``, so
    it takes the port's `Config` as it is."""
    recipes = _port_recipes()
    assert len(recipes) >= 30
    seen = set()
    for name, config in recipes.items():
        got = [_signature(cb) for cb in callbacks.get_callbacks(config, "train")]
        want = [_signature(cb) for cb in jax_callbacks.get_callbacks(config, "train")]
        assert got == want, name
        assert callbacks.get_callbacks(config, "test") == jax_callbacks.get_callbacks(config, "test") == []
        seen |= {s[2] for s in got}
    assert len(seen) >= 5  # markers and several visualizations


def test_an_unknown_visualization_is_refused():
    config = port_configs.toy_gaussian_bubbles_config()
    config.training.visualization_callback = "no_such_callback"
    with pytest.raises(ValueError, match="no_such_callback"):
        callbacks.get_callbacks(config)


def test_freq_gate_fires_where_jaxs_does():
    for viz_freq, snapshot in ((0, 4), (3, 4), (0, 5000)):
        config = Config(training=Config(visualization_freq=viz_freq, snapshot_freq=snapshot))
        fired = {"port": [], "jax": []}
        gates = {
            "port": callbacks._FreqGated(config, lambda tr, s: fired["port"].append(s)),
            "jax": jax_callbacks._FreqGated(config, lambda tr, s: fired["jax"].append(s)),
        }
        for step in range(1, 25):
            for gate in gates.values():
                gate(None, step)
        assert fired["port"] == fired["jax"] == [s for s in range(1, 25) if s % (viz_freq or snapshot) == 0]


# ---- the visualization callbacks against JAX's -------------------------------


class RecordingWriter:
    """A writer that keeps what a callback hands it, as numpy arrays keyed
    by (tag, step).  JAX figures become their data: the scatter's points,
    the curve's (x, y)."""

    def __init__(self):
        self.records = {}

    def add_image(self, tag, img, step):
        self.records[(tag, step)] = np.asarray(img, np.float32)

    def add_scalar(self, tag, value, step):
        self.records[(tag, step)] = np.float32(value)

    def add_points(self, tag, points, step):
        self.records[(tag, step)] = np.asarray(points, np.float32)

    def add_curve(self, tag, xs, ys, step):
        self.records[(tag, step)] = np.stack([np.asarray(xs, np.float64), np.asarray(ys, np.float64)])

    def add_figure(self, tag, fig, step):
        ax = fig.axes[0]
        if ax.collections:
            self.add_points(tag, ax.collections[0].get_offsets(), step)
        else:
            line = ax.lines[0]
            self.add_curve(tag, line.get_xdata(), line.get_ydata(), step)


class StubData:
    def __init__(self, batch):
        self.batch = batch

    def val_iterator(self, batch_size=None):
        yield {k: v[:batch_size] for k, v in self.batch.items()}


def _jax_config(jconfig, **training):
    jconfig.training.visualization_freq = 3
    jconfig.training.visualization_p_steps = P_STEPS
    for k, v in training.items():
        setattr(jconfig.training, k, v)
    return jconfig


def _weights(jconfig, seed=1):
    """The JAX module, numpy params (every leaf redrawn, a Fourier W kept)
    and the port model holding them."""
    try:
        module, params = init_model(jconfig, jax.random.key(0))
    finally:
        reset_jax_dispatch()
    params = jax.device_get(params)
    out = randomize_params(params, seed)
    tree = params.get("unet", params)
    if "fourier" in tree:
        out.get("unet", out)["fourier"]["W"] = np.asarray(tree["fourier"]["W"])
    return module, out


def _run_both(name, jconfig, draws, batch=None, fold_draws=None):
    """The JAX callback ``name`` and the port's on the same weights and
    draws; returns both writers' records."""
    tconfig = port_config(jconfig)
    module, params = _weights(jconfig)
    jwriter, twriter = RecordingWriter(), RecordingWriter()
    jtrainer = types.SimpleNamespace(
        module=module, state=types.SimpleNamespace(ema=types.SimpleNamespace(params=params)),
        writer=jwriter, datamodule=StubData(batch),
    )
    try:
        jax_registry.callbacks.get(name)(jconfig, "train")(jtrainer, STEP)
    finally:
        reset_jax_dispatch()

    model = create_model(tconfig, device="cpu").train()
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    live = copy.deepcopy(model.state_dict())
    shadow = {n: p.detach().clone() for n, p in model.named_parameters()}
    queue = [Replay(draws)] if draws is not None else None

    def noise(step, *fold):
        assert step == STEP
        return Replay([fold_draws[fold]]) if fold else queue.pop(0)

    ttrainer = types.SimpleNamespace(
        state=types.SimpleNamespace(model=model, ema=types.SimpleNamespace(params=shadow)),
        writer=twriter, datamodule=StubData(batch), device=torch.device("cpu"), callback_noise=noise,
    )
    registry.callbacks.get(name)(tconfig, "train")(ttrainer, STEP)
    if queue:
        assert not queue[0].draws, "the port drew less than JAX"
    assert model.training and all(torch.equal(v, model.state_dict()[k]) for k, v in live.items())
    return jwriter.records, twriter.records


def _hold(got, want):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape, (key, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL * max(np.abs(w).max(), 1e-30), err_msg=str(key))


def _ncsnpp_toy(channels=3, lightning_module="base", callback="base", **model):
    from _torch_port_toy import ncsnpp_toy_config

    c = ncsnpp_toy_config(jax_base)
    c.training.lightning_module = lightning_module
    c.training.visualization_callback = callback
    c.data.num_channels, c.data.shape = channels, [channels, 16, 16]
    c.eval.batch_size = 2
    c.model.sigma_max = 1.0  # samples near [0, 1], where the grids clip
    for k, v in model.items():
        setattr(c.model, k, v)
    return c


@pytest.mark.parametrize("show_evolution", [False, True])
def test_base_matches_jax(show_evolution):
    jconfig = _jax_config(_ncsnpp_toy(), show_evolution=show_evolution)
    shape = (2, 16, 16, 3)
    draws = jax_unconditional_draws(jax.random.key(STEP), P_STEPS, shape, "reverse_diffusion", "langevin")
    want, got = _run_both("base", jconfig, draws)
    assert ("generated_images", STEP) in want
    assert (("generation_evolution/filmstrip", STEP) in want) == show_evolution
    _hold(got, want)


def _fcn_toy():
    from configs.toy_gaussian_bubbles import get_config

    return _jax_config(get_config())


@pytest.mark.parametrize("name", ["2D", "2DVisualization"])
def test_2d_matches_jax(name):
    jconfig = _fcn_toy()
    draws = jax_unconditional_draws(jax.random.key(STEP), P_STEPS, (512, 2), "reverse_diffusion", "langevin")
    want, got = _run_both(name, jconfig, draws)
    assert list(want) == [("samples_2d", STEP)] and want[("samples_2d", STEP)].shape == (512, 2)
    _hold(got, want)


def test_gradient_visualization_matches_jax():
    """20 prior draws, each from ``fold_in(key(step), int(t * 1e3))``."""
    jconfig = _fcn_toy()
    key = jax.random.key(STEP)
    fold_draws = {
        (int(t * 1e3),): np.asarray(jax.random.normal(jax.random.fold_in(key, int(t * 1e3)), (16, 2)))
        for t in np.linspace(1e-3, 1.0, 20)
    }
    want, got = _run_both("GradientVisualization", jconfig, None, fold_draws=fold_draws)
    assert list(want) == [("score_norm_vs_t", STEP)] and want[("score_norm_vs_t", STEP)].shape == (2, 20)
    _hold(got, want)


def _paired_toy():
    from _torch_port_toy import jax_toy_config

    c = jax_toy_config(fused_tail=False)
    c.eval.batch_size = 2
    c.model.sigma_max_x = 1.0  # samples near [0, 1], where the grid clips
    return c


@pytest.mark.parametrize("show_evolution", [False, True])
def test_paired_matches_jax(show_evolution):
    jconfig = _jax_config(_paired_toy(), show_evolution=show_evolution)
    rng = np.random.RandomState(3)
    batch = {"x": rng.rand(3, 32, 32, 3).astype(np.float32), "y": rng.rand(3, 32, 32, 3).astype(np.float32)}
    draws = jax_sampler_draws(jax.random.key(STEP), P_STEPS, (2, 32, 32, 3), False)
    want, got = _run_both("paired", jconfig, draws, batch)
    assert want[("paired_y_sample_gt", STEP)].shape == (3, 64, 96)
    assert (("val_joint_evolution/filmstrip", STEP) in want) == show_evolution
    _hold(got, want)


def test_haar_multiscale_matches_jax():
    """An unconditional DDPM on 12 Haar channels (16px), with the
    supergrid trajectory."""
    jconfig = _ncsnpp_toy(12, "haar_multiscale", "haar_multiscale", name="ddpm", output_channels=12)
    jconfig.data.effective_image_size = 16
    jconfig = _jax_config(jconfig, show_evolution=True)
    draws = jax_unconditional_draws(jax.random.key(STEP), P_STEPS, (4, 16, 16, 12), "reverse_diffusion", "langevin")
    want, got = _run_both("haar_multiscale", jconfig, draws)
    assert sorted(t for t, _ in want) == ["haar_reconstructed", "haar_super_grid_evolution/filmstrip", "haar_supergrid"]
    _hold(got, want)


def test_conditional_haar_multiscale_matches_jax():
    """The texture64 pyramid's scale-32 recipe (VS-CMDE on the 9 detail
    channels of 16px, given the DC band), nf cut to 16."""
    from configs.artifacts.texture64_haar_scales import scale_config

    jconfig = scale_config(32)
    jconfig.model.nf, jconfig.model.num_res_blocks = 16, 1
    jconfig = _jax_config(jconfig)
    rng = np.random.RandomState(4)
    batch = {"x": rng.randn(4, 16, 16, 9).astype(np.float32), "y": rng.rand(4, 16, 16, 3).astype(np.float32)}
    draws = jax_sampler_draws(jax.random.key(STEP), P_STEPS, (4, 16, 16, 9), False, y_shape=(4, 16, 16, 3))
    want, got = _run_both("conditional_haar_multiscale", jconfig, draws, batch)
    assert want[("conditional_haar_samples", STEP)].shape == (3, 4 * 32, 96)
    _hold(got, want)


@pytest.mark.parametrize("name,scale", [("KxSR", 4), ("bicubic_SR", 2)])
def test_sr_visualizations_match_jax(name, scale):
    """The DF2K direct recipe's ``ncsnpp_KxSR`` at 32px (as
    `tests/test_torch_ncsnpp.py` cuts it), y 8px (4x) or 16px (2x)."""
    from conditional_score_diffusion_tpu.configs.srflow import df2k_config

    jconfig = df2k_config("direct")
    ysize = 32 // scale
    jconfig.data.image_size = jconfig.data.effective_image_size = jconfig.data.target_resolution = 32
    jconfig.data.shape_x, jconfig.data.shape_y, jconfig.data.scale = [3, 32, 32], [3, ysize, ysize], scale
    jconfig.model.nf, jconfig.model.ch_mult, jconfig.model.num_res_blocks = 16, (1, 2, 2), 1
    jconfig.model.attn_resolutions = (16,)
    jconfig = _jax_config(jconfig, visualization_callback=name)
    rng = np.random.RandomState(5)
    batch = {"x": rng.rand(4, 32, 32, 3).astype(np.float32), "y": rng.rand(4, ysize, ysize, 3).astype(np.float32)}
    draws = jax_sampler_draws(jax.random.key(STEP), P_STEPS, (4, 32, 32, 3), False, y_shape=batch["y"].shape)
    want, got = _run_both(name, jconfig, draws, batch)
    assert want[(f"{name}_samples", STEP)].shape == (3, 4 * 32, 96)
    _hold(got, want)


def test_paired3d_frames_match_jax(monkeypatch):
    """Both callbacks on a stub task that samples fixed gray volumes
    (2, 6, 8, 10, 1): the reconstruction scalar, the middle slices and the
    fly-through filmstrips along the three axes."""
    rng = np.random.RandomState(6)
    samples = rng.rand(2, 6, 8, 10, 1).astype(np.float32) * 1.2 - 0.1
    batch = {"x": rng.rand(2, 6, 8, 10, 1).astype(np.float32), "y": rng.rand(2, 6, 8, 10, 1).astype(np.float32)}

    class StubTask:
        def __init__(self, config, module):
            pass

        def sampling_fn(self, shape, **kw):
            assert tuple(shape) == samples.shape
            return lambda *args, **kwargs: (samples, {})

    monkeypatch.setattr(jax_tasks, "create_task", StubTask)
    monkeypatch.setattr(tasks, "create_task", StubTask)
    config = _jax_config(_fcn_toy())
    config.data.shape = [1, 6, 8, 10]
    jwriter, twriter = RecordingWriter(), RecordingWriter()
    jtrainer = types.SimpleNamespace(
        module=None, state=types.SimpleNamespace(ema=types.SimpleNamespace(params=None)), writer=jwriter,
        datamodule=StubData(batch),
    )
    jax_callbacks.paired3d_visualization_callback(config, "train")(jtrainer, STEP)
    model = torch.nn.Linear(2, 2)
    ttrainer = types.SimpleNamespace(
        state=types.SimpleNamespace(model=model, ema=types.SimpleNamespace(params=dict(model.named_parameters()))),
        writer=twriter, datamodule=StubData(batch), device=torch.device("cpu"), callback_noise=lambda step: None,
    )
    callbacks.paired3d_visualization_callback(port_config(config), "train")(ttrainer, STEP)
    assert len(jwriter.records) == 7
    _hold(twriter.records, jwriter.records)


# ---- a failing callback ------------------------------------------------------


def _toy_trainer(tmp_path):
    config = port_configs.toy_gaussian_bubbles_config()
    config.data.data_samples = 4000
    config.training.log_freq = 1
    config.training.visualization_freq = 1
    config.training.visualization_p_steps = 4
    return Trainer(config, str(tmp_path), device="cpu")


def _snapshot(trainer):
    state = trainer.state
    return (
        {n: p.detach().clone() for n, p in state.model.named_parameters()},
        {n: p.clone() for n, p in state.ema.params.items()},
        copy.deepcopy(state.optimizer.state_dict()),
        state.model.training,
    )


def _same(a, b):
    params_a, ema_a, opt_a, mode_a = a
    params_b, ema_b, opt_b, mode_b = b
    assert mode_a == mode_b
    for x, y in ((params_a, params_b), (ema_a, ema_b)):
        assert x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)
    assert opt_a["param_groups"] == opt_b["param_groups"]
    for k, s in opt_a["state"].items():
        assert all(torch.equal(v, opt_b["state"][k][n]) for n, v in s.items())


class Boom(RuntimeError):
    pass


def test_a_callback_failing_half_way_leaves_training_as_it_was(tmp_path):
    """The ``2D`` callback's sampler raises at its third draw: nothing of the
    trainer changed, and the failure is counted and logged."""
    trainer = _toy_trainer(tmp_path)
    trainer.fit(max_steps=2)  # Adam moments and an EMA that differs from the params
    for mode in (True, False):
        trainer.state.model.train(mode)
        before = _snapshot(trainer)
        drawn = []

        def noise(step):
            def draw(shape):
                drawn.append(shape)
                if len(drawn) == 3:
                    raise Boom("the sampler failed")
                return torch.randn(shape)

            return draw

        trainer.callback_noise = noise
        viz = callbacks.get_callbacks(trainer.config)[-1]
        trainer._run_callback(viz, 7)
        assert len(drawn) == 3
        _same(before, _snapshot(trainer))
    assert trainer.callback_failures == {"_FreqGated": 2}
    scalars = read_scalars(os.path.join(tmp_path, "scalars.jsonl"))
    assert [(t, v, s) for t, v, s in scalars if t.startswith("callback_failures")] == [
        ("callback_failures/_FreqGated", 1.0, 7), ("callback_failures/_FreqGated", 2.0, 7)
    ]
    with open(os.path.join(tmp_path, "callback_errors.jsonl")) as f:
        errors = [json.loads(line) for line in f]
    assert errors[0] == {"tag": "callback_errors/_FreqGated", "text": "Boom: the sampler failed", "step": 7}


def test_fit_with_a_failing_callback_trains_as_without(tmp_path):
    """`fit` with a callback that fails at every step (inside the EMA
    model) against `fit` without callbacks: the same parameters, EMA and
    Adam state bit for bit, the model still in train mode, 3 failures."""

    class Failing:
        def __call__(self, trainer, step):
            with callbacks.ema_model(trainer) as model:
                model(torch.zeros(2, 2), torch.ones(2))
                raise Boom(f"at {step}")

    a, b = _toy_trainer(tmp_path / "a"), _toy_trainer(tmp_path / "b")
    a.fit(max_steps=3, callbacks=[Failing()])
    b.fit(max_steps=3, callbacks=[])
    assert a.callback_failures == {"Failing": 3} and b.callback_failures == {}
    assert a.state.model.training and a.state.step == b.state.step == 3
    _same(_snapshot(a), _snapshot(b))


def test_fit_runs_the_recipes_callbacks(tmp_path):
    """`fit()` builds the recipe's callbacks: the toy's ``2D`` fires at
    every multiple of ``visualization_freq`` and writes its samples; the
    scalars and images go where the writer says."""
    trainer = _toy_trainer(tmp_path)
    trainer.config.training.visualization_freq = 2
    trainer.fit(max_steps=4)
    assert trainer.callback_failures == {}
    assert sorted(os.listdir(tmp_path / "samples_2d")) == ["2.npy", "4.npy"]
    trainer.writer.add_image("a/b", np.full((3, 4, 5), 0.5, np.float32), 9)
    trainer.writer.add_curve("score_norm_vs_t", np.array([0.001, 1.0]), np.array([3.0, 4.0]), 9)
    assert os.path.exists(tmp_path / "images" / "a" / "b" / "9.png")
    assert np.load(tmp_path / "score_norm_vs_t" / "9.npy").shape == (2, 2)
    tags = {t for t, _, _ in read_scalars(os.path.join(tmp_path, "scalars.jsonl"))}
    assert {"score_norm_vs_t/t=0.0010", "score_norm_vs_t/t=1.0000"} <= tags
