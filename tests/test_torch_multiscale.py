"""The port's ``--mode multi_scale_test`` (`eval/multiscale.py`) and its Haar
tasks against the JAX package's.

The two tiny chains of the JAX `tests/test_multiscale.py` (Haar 8 -> 16 ->
32 and bicubic 8 -> 16 -> 32) run through both packages on the same
recipes (the JAX ones, copied field by field into the port's `Config`), the
same random weights per scale (numpy, through `models/convert.py`; the
port reads them from EMA files) and the same noise: the JAX key chain's
draws replayed into the port's sampler.  The final images agree within
1e-4 of their scale; both write the same files (PNG pixels within one
level: the port rounds, JAX truncates) and the same ``metrics.json`` (the
port's metrics run in float64, JAX's in float32: 1e-4 relative).  Also:
the image helpers exactly, the Haar VS-CMDE task's sigma_y after
``reconfigure(step)`` at 1e-5, ``inpaint_hf`` naming its ROADMAP item,
and the CLI on a toy master.
"""

import glob
import json
import os
import pickle
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, os.path.dirname(__file__))

from _torch_port_toy import Replay, randomize_params, reset_jax_dispatch  # noqa: E402
from conditional_score_diffusion_tpu.eval import multiscale as jax_ms  # noqa: E402
from conditional_score_diffusion_tpu.training import callbacks as jax_callbacks  # noqa: E402
from conditional_score_diffusion_tpu.training.tasks import create_task as jax_create_task  # noqa: E402
from conditional_score_diffusion_tpu_torch import main as cli  # noqa: E402
from conditional_score_diffusion_tpu_torch.configs import Config  # noqa: E402
from conditional_score_diffusion_tpu_torch.eval import multiscale  # noqa: E402
from conditional_score_diffusion_tpu_torch.models.convert import flax_to_state_dict  # noqa: E402
from conditional_score_diffusion_tpu_torch.training import callbacks  # noqa: E402
from conditional_score_diffusion_tpu_torch.training.checkpoint import save_ema  # noqa: E402
from conditional_score_diffusion_tpu_torch.training.tasks import create_task  # noqa: E402

torch.set_num_threads(1)

REL_TOL = 1e-4
METRIC_REL_TOL = 1e-4


def port_config(jax_config):
    """The port's `Config` with every field of an ml_collections recipe."""

    def conv(v):
        if isinstance(v, dict):
            return Config(**{k: conv(x) for k, x in v.items()})
        return v

    return conv(jax_config.to_dict())


def _write_pklv4(path, n, size):
    rng = np.random.RandomState(0)
    with open(path, "wb") as f:
        pickle.dump([rng.randint(0, 255, (size, size, 3), dtype=np.uint8) for _ in range(n)], f)


def _haar_master(tmp_path):
    """The JAX test's Haar chain: two scales of `haar_conditional_config`
    at 16 and 32 on celebA-HQ-160-named fixtures, nf 8, 10 steps."""
    import ml_collections
    from test_multiscale import _tiny_haar_scale_config

    for scale_dir, size in [("s16", 16), ("s32", 32)]:
        ds_dir = tmp_path / scale_dir / "celebA-HQ-160"
        ds_dir.mkdir(parents=True)
        for f, s in [
            ("CelebAHq_160_MBic_tr.pklv4", size),
            ("CelebAHq_160_MBic_va.pklv4", size),
            ("CelebAHq_160_MBic_tr_X8.pklv4", size // 2),
            ("CelebAHq_160_MBic_va_X8.pklv4", size // 2),
        ]:
            _write_pklv4(str(ds_dir / f), 8, s)
    master = ml_collections.ConfigDict()
    master.coordinate_space = "haar"
    master.seed = 0
    master.scale_16 = _tiny_haar_scale_config(str(tmp_path / "s16"), 16)
    master.scale_32 = _tiny_haar_scale_config(str(tmp_path / "s32"), 32)
    return master, 10


def _bicubic_master(tmp_path):
    """The JAX test's bicubic chain: two `ddpm_2xSR` scales at 16 and 32,
    nf 8, 5 steps."""
    import ml_collections
    from test_multiscale import _tiny_bicubic_scale_config

    for name, size in [("toybic16", 16), ("toybic32", 32)]:
        d = tmp_path / name
        d.mkdir()
        for phase in ("train", "val", "test"):
            _write_pklv4(str(d / f"{name}-{phase}.pklv4"), 6, size)
            _write_pklv4(str(d / f"{name}-{phase}_X2.pklv4"), 6, size // 2)
    master = ml_collections.ConfigDict()
    master.coordinate_space = "bicubic"
    master.seed = 0
    master.scale_16 = _tiny_bicubic_scale_config(str(tmp_path), "toybic16", 16)
    master.scale_32 = _tiny_bicubic_scale_config(str(tmp_path), "toybic32", 32)
    return master, 5


def chain_draws(seed, shapes, p_steps):
    """The JAX chain's draws for one batch (`eval/multiscale.py`: a key split
    off per scale; the conditional sampler's prior, then per step the y
    perturbations and the predictor's draw, ``conditional_none`` drawing
    nothing), in the port's order of use.  ``shapes``: per scale, lowest
    first, ``(x_shape, y_shape)``."""
    rng = jax.random.key(seed)
    draws = []
    for x_shape, y_shape in shapes:
        rng, sample_rng = jax.random.split(rng)
        r, prior = jax.random.split(sample_rng)
        draws.append(jax.random.normal(prior, x_shape))
        for _ in range(p_steps):
            r, ryc, _, ryp, rp = jax.random.split(r, 5)
            draws += [jax.random.normal(ryc, y_shape), jax.random.normal(ryp, y_shape), jax.random.normal(rp, x_shape)]
    return [np.asarray(d) for d in draws]


def _scale_shapes(master, batch):
    scales = sorted((master[k] for k in master.keys() if k.startswith("scale")), key=lambda c: c.data.image_size)
    out = []
    for c in scales:
        (cx, hx, wx), (cy, hy, wy) = c.data.shape_x, c.data.shape_y
        out.append(((batch, hx, wx, cx), (batch, hy, wy, cy)))
    return out


def _run_both(tmp_path, monkeypatch, make_master):
    jmaster, p_steps = make_master(tmp_path)
    params = {}
    real_init = jax_ms.init_model

    def init_random(config, rng):
        module, p = real_init(config, rng)
        params[int(config.data.image_size)] = randomize_params(jax.device_get(p), seed=int(config.data.image_size))
        return module, params[int(config.data.image_size)]

    monkeypatch.setattr(jax_ms, "init_model", init_random)
    try:
        want = jax_ms.run_multi_scale_test(jmaster, str(tmp_path / "jax"), p_steps=p_steps, num_batches=1)
    finally:
        reset_jax_dispatch()

    master = port_config(jmaster)
    for key in ("scale_16", "scale_32"):
        config = getattr(master, key)
        size = int(config.data.image_size)
        config.model.checkpoint_path = save_ema(str(tmp_path / f"ema_{size}.pt"), 0, flax_to_state_dict(params[size]))
    batch = jmaster.scale_16.eval.batch_size
    noise = Replay(chain_draws(jmaster.seed, _scale_shapes(jmaster, batch), p_steps))
    got = multiscale.run_multi_scale_test(master, str(tmp_path / "port"), p_steps=p_steps, device="cpu", noise=noise)
    assert not noise.draws  # every JAX draw was used
    return want, got


def _files(root):
    return sorted(os.path.relpath(p, root) for p in glob.glob(os.path.join(root, "multi_scale", "*")))


@pytest.mark.parametrize("make_master", [_haar_master, _bicubic_master], ids=["haar", "bicubic"])
def test_chain_matches_jax(tmp_path, monkeypatch, make_master):
    want, got = _run_both(tmp_path, monkeypatch, make_master)
    assert len(got) == len(want) == 1
    g, w = got[0], np.asarray(want[0])
    assert g.shape == w.shape == (2, 32, 32, 3) and np.isfinite(g).all()
    assert np.abs(g - w).max() <= REL_TOL * np.abs(w).max(), (np.abs(g - w).max(), np.abs(w).max())

    jroot, proot = str(tmp_path / "jax"), str(tmp_path / "port")
    assert _files(proot) == _files(jroot)
    assert len(_files(proot)) == 2 + 2  # 2 images, the pyramid, metrics.json
    for name in _files(proot):
        if name.endswith(".png"):
            a = np.asarray(Image.open(os.path.join(proot, name))).astype(int)
            b = np.asarray(Image.open(os.path.join(jroot, name))).astype(int)
            assert a.shape == b.shape and np.abs(a - b).max() <= 1, name
    with open(os.path.join(proot, "multi_scale", "metrics.json")) as f:
        pm = json.load(f)
    with open(os.path.join(jroot, "multi_scale", "metrics.json")) as f:
        jm = json.load(f)
    assert sorted(pm) == sorted(jm) and sorted(pm["per_batch"][0]) == sorted(jm["per_batch"][0])
    for k, v in jm.items():
        if isinstance(v, float):
            assert abs(pm[k] - v) <= METRIC_REL_TOL * abs(v), k
        elif k != "per_batch":
            assert pm[k] == v, k
    events = lambda root: glob.glob(os.path.join(root, "autoregressive_samples", "events.*"))  # noqa: E731
    assert bool(events(proot)) == bool(events(jroot))


def test_image_helpers_match_jax():
    rng = np.random.RandomState(0)
    pyramid = [rng.rand(2, s, s, 3).astype(np.float32) * 7 - 3 for s in (8, 16, 32)]
    out = multiscale.rescale_and_concatenate(pyramid)
    assert out.shape == (2, 32, 96, 3)
    assert np.array_equal(out, jax_ms.rescale_and_concatenate(pyramid))
    coeffs = rng.randn(3, 8, 8, 12).astype(np.float32)
    assert np.array_equal(callbacks.haar_supergrid(coeffs), jax_callbacks.haar_supergrid(coeffs))
    imgs = rng.rand(5, 4, 6, 3).astype(np.float32) * 1.4 - 0.2
    for nrow in (None, 1, 2):
        assert np.array_equal(callbacks.image_grid(imgs, nrow), jax_callbacks.image_grid(imgs, nrow))
    assert np.array_equal(callbacks._normalise_per_image(imgs), jax_callbacks._normalise_per_image(imgs))


@pytest.mark.parametrize("step", [0, 1000, 4000, 12000, 14000])
@pytest.mark.parametrize("size", [32, 64])
def test_haar_task_reconfigure_matches_jax(size, step):
    """The texture64 pyramid's VS-CMDE task after ``reconfigure(step)``:
    the SDE's sigma_y (and sigma_x) are JAX's at 1e-5."""
    from configs.artifacts.texture64_haar_scales import scale_config
    from conditional_score_diffusion_tpu_torch.configs import texture64_haar_scale_config

    jtask = jax_create_task(scale_config(size), None)
    task = create_task(texture64_haar_scale_config(size), None)
    assert type(task).__name__ == type(jtask).__name__ == "HaarDecreasingVarianceConditionalTask"
    jtask.reconfigure(step)
    task.reconfigure(step)
    for k in ("x", "y"):
        for attr in ("sigma_min", "sigma_max"):
            got, want = float(getattr(task.sde[k], attr)), float(getattr(jtask.sde[k], attr))
            assert abs(got - want) <= 1e-5 * abs(want), (k, attr, got, want)
    assert task.sampling_eps == jtask.sampling_eps
    x = np.random.RandomState(size).rand(2, 8, 8, 3).astype(np.float32)
    assert np.array_equal(task.get_dc_coefficients(torch.from_numpy(x)).numpy(), np.asarray(jtask.get_dc_coefficients(x)))


def test_deprecated_task_anneals_only_sigma_max_y():
    from conditional_score_diffusion_tpu.configs.celeba_sr import celeba_sr_160_config as jax_recipe
    from conditional_score_diffusion_tpu_torch.configs import celeba_sr_160_config

    jc, c = jax_recipe("ours_DV"), celeba_sr_160_config("ours_DV")
    jc.training.lightning_module = c.training.lightning_module = "deprecated_conditional_decreasing_variance"
    jtask, task = jax_create_task(jc, None), create_task(c, None)
    for step in (0, 1000, 250000):
        jtask.reconfigure(step)
        task.reconfigure(step)
        for attr in ("sigma_min", "sigma_max"):
            assert abs(float(getattr(task.sde["y"], attr)) - float(getattr(jtask.sde["y"], attr))) <= 1e-5 * float(
                getattr(jtask.sde["y"], attr)
            )
        assert float(task.sde["y"].sigma_min) == c.model.sigma_min_y
        assert float(task.sde_for_step(step)["y"].sigma_max) == pytest.approx(float(task.sde["y"].sigma_max), rel=1e-6)


def test_haar_multiscale_task(tmp_path):
    """``haar_multiscale``: images go to Haar coefficients before the loss,
    the sampler returns coefficients or images, and ``inpaint_hf`` (over an
    SDE cut to 3 steps) returns coefficients whose DC band is its input."""
    from conditional_score_diffusion_tpu.configs.extra import haar_multiscale_unconditional_config
    from conditional_score_diffusion_tpu_torch.models import create_model
    from conditional_score_diffusion_tpu_torch.ops.haar import haar_forward

    jc = haar_multiscale_unconditional_config(16)
    c = port_config(jc)
    c.model.nf, c.model.ch_mult, c.model.num_res_blocks, c.model.attn_resolutions = 8, (1, 2), 1, (4,)
    c.model.num_scales = 3
    model = create_model(c, "cpu")
    task, jtask = create_task(c, model), jax_create_task(jc, None)
    assert type(task).__name__ == type(jtask).__name__ == "HaarMultiScaleTask"
    x = np.random.RandomState(0).rand(2, 16, 16, 3).astype(np.float32)
    assert np.array_equal(task.prepare_batch(x), np.asarray(jtask.prepare_batch(x)))
    shape = (2, 8, 8, 12)
    gen = torch.Generator().manual_seed(0)
    coeffs, _ = task.sampling_fn(shape, p_steps=2, corrector="none")(gen, model)
    gen = torch.Generator().manual_seed(0)
    images, _ = task.sampling_fn(shape, space="image", p_steps=2, corrector="none")(gen, model)
    assert coeffs.shape == shape and images.shape == (2, 16, 16, 3)
    assert torch.allclose(haar_forward(images), coeffs, atol=1e-5)
    dc = torch.from_numpy(task.prepare_batch(x)[..., :3])
    filled, info = task.inpaint_hf(torch.Generator().manual_seed(1), model, dc)
    assert filled.shape == shape and info == {} and torch.isfinite(filled).all()
    assert torch.equal(filled[..., :3], dc) and filled[..., 3:].abs().max() > 0


def test_cli_runs_a_toy_master(tmp_path, monkeypatch):
    """``main.py --mode multi_scale_test --device cpu`` on a master file
    (the bicubic toy chain with the default init; the chain's 2000 steps
    cut to 3)."""
    import functools

    monkeypatch.setattr(multiscale, "run_multi_scale_test", functools.partial(multiscale.run_multi_scale_test, p_steps=3))
    recipe = tmp_path / "toy_master.py"
    recipe.write_text(textwrap.dedent(f"""
        import pathlib, sys
        sys.path.insert(0, {os.path.dirname(__file__)!r})
        from test_torch_multiscale import _bicubic_master, port_config

        def get_config():
            master, _ = _bicubic_master(pathlib.Path({str(tmp_path)!r}))
            return port_config(master)
    """))
    log_path = tmp_path / "logs"
    cli.main(["--mode", "multi_scale_test", "--config", str(recipe), "--log_path", str(log_path), "--device", "cpu"])
    with open(log_path / "multi_scale" / "metrics.json") as f:
        m = json.load(f)
    assert m["coordinate_space"] == "bicubic" and m["p_steps"] == 3 and np.isfinite(m["mean_psnr"])
    assert len(glob.glob(str(log_path / "multi_scale" / "batch0_*.png"))) == 2
    assert "multi_scale_test" in cli.MODES
