"""The 2-D GaussianBubbles toy in the port against the JAX package: the
synthetic data and its datamodule's batches (bit for bit: both are numpy
draws of one seeded generator), the FCN forward on converted weights
(1e-6 of the output's largest magnitude), three whole train steps on the
JAX key chain's t and noise (loss 1e-5 relative; each parameter and EMA
tensor within 1e-5 of the parameters' scale, their largest magnitude: a
bias that starts at 0 has moved by ~3 lr after three Adam steps),
`Trainer.fit` on the toy recipe for 600 steps on the CPU, whose loss must
fall as the JAX `tests/test_train_e2e.py` asks, with its ``2D`` callback's
samples near the unit circle, and the three toy recipes field by field.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_toy import to_torch
from configs.toy_gaussian_bubbles import get_config as jax_toy_config
from conditional_score_diffusion_tpu.configs.extra import synthetic_config as jax_synthetic_config
from conditional_score_diffusion_tpu.data import create_datamodule as jax_create_datamodule
from conditional_score_diffusion_tpu.data import synthetic as jax_synthetic
from conditional_score_diffusion_tpu.models import init_model
from conditional_score_diffusion_tpu.training import state as jax_state
from conditional_score_diffusion_tpu.training import steps as jax_steps
from conditional_score_diffusion_tpu_torch import main as cli
from conditional_score_diffusion_tpu_torch.configs import synthetic_config, toy_gaussian_bubbles_config
from conditional_score_diffusion_tpu_torch.data import create_datamodule, synthetic
from conditional_score_diffusion_tpu_torch.models import create_model
from conditional_score_diffusion_tpu_torch.models.convert import flax_to_state_dict
from conditional_score_diffusion_tpu_torch.training.state import create_train_state
from conditional_score_diffusion_tpu_torch.training.steps import make_train_step
from conditional_score_diffusion_tpu_torch.training.trainer import Trainer, read_scalars

torch.set_num_threads(1)

KEY = jax.random.key(21)
LOSS_RTOL, FORWARD_TOL, PARAM_TOL = 1e-5, 1e-6, 1e-5


@pytest.mark.parametrize("kind", ["bubbles", "bubbles1", "moons"])
def test_synthetic_draws_match_jax(kind):
    for seed in (0, 42):
        if kind == "moons":
            got = synthetic.two_moons(1001, 0.015, np.random.default_rng(seed))
            want = jax_synthetic.two_moons(1001, 0.015, np.random.default_rng(seed))
        else:
            mixtures = 1 if kind == "bubbles1" else 4
            got = synthetic.gaussian_bubbles(1001, mixtures, np.random.default_rng(seed))
            want = jax_synthetic.gaussian_bubbles(1001, mixtures, np.random.default_rng(seed))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dataset_type", ["GaussianBubbles", "Moons"])
def test_datamodule_batches_match_jax(dataset_type):
    """The splits, and the first batches of the shuffled looping train
    iterator (over an epoch boundary) and of the val and test iterators."""
    configs = [jax_synthetic_config(), synthetic_config()]
    for c in configs:
        c.data.dataset_type = dataset_type
        c.data.data_samples = 2000
        c.training.batch_size = 96
        c.eval.batch_size = 64
    jdm, tdm = jax_create_datamodule(configs[0]), create_datamodule(configs[1])
    jdm.setup(), tdm.setup()
    for split in ("train_data", "val_data", "test_data"):
        np.testing.assert_array_equal(getattr(tdm, split), getattr(jdm, split))
    jt, tt = jdm.train_iterator(), tdm.train_iterator()
    for _ in range(20):  # 16 batches an epoch: the second epoch's reshuffle too
        np.testing.assert_array_equal(next(tt), next(jt))
    for name in ("val_iterator", "test_iterator"):
        got, want = list(getattr(tdm, name)(batch_size=64)), list(getattr(jdm, name)(batch_size=64))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_unported_datamodules_name_their_item(tmp_path):
    """Every JAX datamodule is ported: ``haar_multiscale`` and
    ``bicubic_multiscale`` build and yield a batch of a written tree (they
    once named their ROADMAP item); ``image`` (`data/image_folder.py`),
    ``paired`` and ``DUAL-GLOW`` (`data/paired.py`) build, and read their
    folder or A/B tree at setup."""
    from PIL import Image

    from conditional_score_diffusion_tpu_torch.data.builder import create_haar_dataset

    src = tmp_path / "celebA"
    src.mkdir()
    rng = np.random.RandomState(0)
    for i in range(8):
        Image.fromarray(rng.randint(0, 256, (16, 16, 3), dtype=np.uint8)).save(src / f"{i:03d}.jpg")
    create_haar_dataset(str(src), str(tmp_path), "celebA", 16, max_depth=1, split=(0.5, 0.25, 0.25), seed=0)
    config = synthetic_config()
    config.data.base_dir, config.data.dataset, config.data.target_resolution = str(tmp_path), "celebA", 16
    for name, size, level, want in (("haar_multiscale", 8, 1, (2, 8, 8, 3)), ("bicubic_multiscale", 8, 1, None)):
        config.data.datamodule, config.data.image_size, config.data.level = name, size, level
        dm = create_datamodule(config)
        dm.setup()
        batch = next(dm.train_iterator(batch_size=2))
        if want is not None:
            assert batch.shape == want
        else:
            assert batch["x"].shape == (2, 8, 8, 3) and batch["y"].shape == (2, 4, 4, 3)
    config.data.datamodule, config.data.base_dir, config.data.dataset = "image", "no_such_dir", "images"
    dm = create_datamodule(config)
    assert type(dm).__name__ == "ImageDataModule"
    with pytest.raises(FileNotFoundError):
        dm.setup()
    for name in ("paired", "DUAL-GLOW"):
        config.data.datamodule, config.data.base_dir, config.data.dataset = name, "no_such_dir", "pairs"
        dm = create_datamodule(config)
        assert type(dm).__name__ == "PairedDataModule"
        with pytest.raises(FileNotFoundError, match="bad paired tree"):
            dm.setup()


def _toy(warmup=0):
    jconfig, tconfig = jax_toy_config(), toy_gaussian_bubbles_config()
    for c in (jconfig, tconfig):
        c.optim.warmup = warmup
        c.training.batch_size = 64
    module, params = init_model(jconfig, jax.random.key(3))
    return jconfig, tconfig, module, jax.device_get(params)


def _port_model(tconfig, params):
    model = create_model(tconfig, device="cpu")
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return model


@pytest.mark.parametrize("recipe", ["toy", "synthetic"])
def test_fcn_forward_matches_jax(recipe):
    if recipe == "toy":
        jconfig, tconfig, module, params = _toy()
    else:  # 3 hidden layers of 64, dropout 0.25 (off in eval)
        jconfig, tconfig = jax_synthetic_config(), synthetic_config()
        module, params = init_model(jconfig, jax.random.key(4))
        params = jax.device_get(params)
    model = _port_model(tconfig, params)
    assert sorted(n for n, _ in model.named_parameters()) == sorted(flax_to_state_dict(params))
    rng = np.random.RandomState(0)
    x = rng.randn(33, 2).astype(np.float32)
    t = rng.uniform(0.01, 2.0, size=33).astype(np.float32)
    want = np.asarray(module.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FORWARD_TOL * np.abs(want).max())


def test_default_init_is_flax_dense():
    """The port's own init draws as Flax's Dense does: LeCun normal kernels
    (std 1/sqrt(fan_in), truncated at 2 std), zero biases."""
    model = create_model(synthetic_config(), device="cpu")
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            assert not p.any(), name
        else:
            std = 1.0 / np.sqrt(p.shape[1])
            assert p.abs().max() <= 2 * std / 0.87962566103423978 + 1e-7, name
            assert 0.5 * std < p.std() < 1.5 * std, name


def _step_draws(step, shape):
    """The unconditional loss's t and z of JAX train step ``step``
    (`losses/continuous.py`: ``fold_in(rng, step)`` split in 3)."""
    rng_t, rng_z, _ = jax.random.split(jax.random.fold_in(KEY, step), 3)
    return {
        "t": np.asarray(jax.random.uniform(rng_t, (shape[0],), minval=1e-5, maxval=1.0)),
        "x": np.asarray(jax.random.normal(rng_z, shape)),
    }


def test_train_steps_match_jax():
    jconfig, tconfig, module, params = _toy()
    batch = jax_synthetic.gaussian_bubbles(64, 4, np.random.default_rng(5))
    train_step, tx = jax_steps.make_train_step(jconfig, module)
    step = jax.jit(train_step)
    jstate = jax_state.create_train_state(jconfig, params, tx)
    model = _port_model(tconfig, params)
    state = create_train_state(tconfig, model)
    port_step = make_train_step(tconfig, model)
    for i in range(3):
        jstate, m = step(jstate, jnp.asarray(batch), KEY)
        got = port_step(state, torch.from_numpy(batch), noise=to_torch(_step_draws(i, batch.shape)))
        assert abs(float(got["loss"]) - float(m["loss"])) <= LOSS_RTOL * abs(float(m["loss"])), i
    for got, want in ((dict(state.model.named_parameters()), jstate.params), (state.ema.params, jstate.ema.params)):
        want = flax_to_state_dict(jax.device_get(want))
        start = flax_to_state_dict(params)
        scale = max(w.abs().max().item() for w in want.values())
        for name, w in want.items():
            err = (got[name].detach() - w).abs().max().item()
            assert err <= PARAM_TOL * scale, (name, err, scale)
            assert not torch.equal(w, start[name]) or not w.any(), name  # the steps moved it
    assert state.step == int(jstate.step) == 3 and state.ema.num_updates == int(jstate.ema.num_updates)


def test_fit_learns_the_bubbles(tmp_path):
    """600 steps of the toy recipe (as `tests/test_train_e2e.py`: warmup 50,
    20,000 points): the loss falls by 30%, the eval loss is finite, and the
    ``2D`` callback (full 500-step sampling at the snapshot) wrote 512
    samples near the unit circle."""
    config = toy_gaussian_bubbles_config()
    config.training.n_iters = 600
    config.training.eval_freq = 300
    config.training.snapshot_freq = 600
    config.optim.warmup = 50
    config.data.data_samples = 20000
    trainer = Trainer(config, str(tmp_path), device="cpu")
    history = trainer.fit()
    losses = [l for _, l in history["train_loss"]]
    assert losses[-1] < losses[0] * 0.7, f"no training progress: {losses}"
    assert [s for s, _ in history["eval_loss"]] == [300, 600] and np.isfinite(history["eval_loss"][-1][1])
    assert trainer.callback_failures == {}
    samples = np.load(os.path.join(tmp_path, "samples_2d", "600.npy"))
    radii = np.linalg.norm(samples, axis=1)
    assert samples.shape == (512, 2) and np.isfinite(samples).all()
    assert abs(float(radii.mean()) - 1.0) < 0.25 and float(radii.std()) < 0.45, (radii.mean(), radii.std())


def test_cli_names_the_toy_recipes(tmp_path):
    from conditional_score_diffusion_tpu.configs.extra import toy_vp_config as jax_toy_vp_config

    assert cli.load_config("toy_gaussian_bubbles").model.name == "fcn"
    assert cli.load_config("synthetic").training.visualization_callback == "2D"
    recipes = [(jax_toy_vp_config, lambda: cli.load_config("toy_vp")),
               (jax_toy_config, lambda: cli.load_config("toy_gaussian_bubbles"))]
    recipes += [(lambda sde=sde: jax_synthetic_config(sde), lambda sde=sde: synthetic_config(sde))
                for sde in ("vesde", "vpsde")]
    for jax_fn, port_fn in recipes:
        want, got = jax_fn(), port_fn()
        name = got.model.name
        for section in ("training", "data", "model", "optim", "sampling", "eval"):
            assert vars(getattr(got, section)) == dict(getattr(want, section)), (name, section)
    log_path = tmp_path / "logs"
    recipe = tmp_path / "recipe.py"
    recipe.write_text(
        "from conditional_score_diffusion_tpu_torch.configs import toy_gaussian_bubbles_config\n"
        "def get_config():\n"
        "    c = toy_gaussian_bubbles_config()\n"
        "    c.training.n_iters, c.training.visualization_p_steps, c.data.data_samples = 4, 3, 4000\n"
        "    c.training.snapshot_freq = c.training.log_freq = 2\n"
        "    return c\n"
    )
    cli.main(["--mode", "train", "--config", str(recipe), "--log_path", str(log_path), "--device", "cpu"])
    assert [s for t, _, s in read_scalars(str(log_path / "scalars.jsonl")) if t == "train_loss"] == [1, 2, 4]
    assert sorted(os.listdir(log_path / "samples_2d")) == ["2.npy", "4.npy"]
