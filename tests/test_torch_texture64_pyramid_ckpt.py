"""The committed EMA files of the trained texture64 Haar pyramid against the
orbax checkpoints they were converted from, their scores and a short chain
against JAX's, and the `_block` variant's kernel calls.

`conditional_score_diffusion_tpu_torch/assets/texture64_pyramid_scale{32,64}_ema.pt`
(written by `tests/_torch_port_convert_texture64_pyramid.py`) must hold the
EMA of each scale's newest checkpoint (14000 and 12000, the steps JAX's
`_load_scale` restores) bit for bit in float32.  With them, each scale's
conditional score equals JAX's on 2 test batches' inputs at t = 0.5 within
5e-4 of its largest magnitude (a same-weights forward; the VS-CMDE SDE at
the checkpoint's step), and a 3-step chain of both scales on test batch 0
(the JAX key chain's noise replayed) gives JAX's final images within 1e-4
of their scale and its ``metrics.json``.
"""

import json
import os
import sys

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from _torch_port_toy import Replay, reset_jax_dispatch  # noqa: E402
from configs.artifacts.texture64_haar_scales import scale_config as jax_scale_config  # noqa: E402
from configs.artifacts.texture64_multiscale_master import get_config as jax_master_config  # noqa: E402
from conditional_score_diffusion_tpu.models import init_model_shapes_only  # noqa: E402
from conditional_score_diffusion_tpu.models import wrappers as jax_wrappers  # noqa: E402
from conditional_score_diffusion_tpu.training.tasks import create_task as jax_create_task  # noqa: E402
from conditional_score_diffusion_tpu_torch.configs import (  # noqa: E402
    texture64_haar_scale_config,
    texture64_multiscale_master_block_config,
    texture64_multiscale_master_config,
)
from conditional_score_diffusion_tpu_torch.configs.multiscale import pyramid_ema_asset  # noqa: E402
from conditional_score_diffusion_tpu_torch.data.pkl_datasets import PKLDataModule  # noqa: E402
from conditional_score_diffusion_tpu_torch.eval import multiscale  # noqa: E402
from conditional_score_diffusion_tpu_torch.models.convert import state_dict_to_flax  # noqa: E402
from conditional_score_diffusion_tpu_torch.models.wrappers import get_conditional_score_fn, get_score_fn  # noqa: E402
from test_torch_multiscale import chain_draws  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = {32: 14000, 64: 12000}
EMA_FLOATS = {32: 2_182_188, 64: 2_555_340}
SCORE_REL_TOL, CHAIN_REL_TOL, METRIC_REL_TOL = 5e-4, 1e-4, 1e-4
DATASETS = os.path.join(REPO, "datasets")


def checkpoint(size):
    return os.path.join(REPO, "artifacts", "texture64_pyramid", f"scale_{size}", "texture64", "checkpoints")


@pytest.fixture(scope="module")
def orbax_states():
    """Each scale's newest checkpoint as orbax stored it (nested dicts)."""
    return {s: ocp.StandardCheckpointer().restore(os.path.join(checkpoint(s), str(step), "default"))
            for s, step in STEPS.items()}


def _tree_equal(got, want, path=()):
    assert sorted(got) == sorted(want), path
    for k in want:
        if isinstance(want[k], dict):
            _tree_equal(got[k], want[k], path + (k,))
        else:
            w = np.asarray(want[k])
            assert got[k].dtype == w.dtype == np.float32 and np.array_equal(got[k], w), path + (k,)


@pytest.mark.parametrize("size", [32, 64])
def test_committed_ema_equals_the_checkpoint_bit_for_bit(orbax_states, size):
    assert max(int(d) for d in os.listdir(checkpoint(size)) if d.isdigit()) == STEPS[size]  # JAX's latest_step()
    saved = torch.load(pyramid_ema_asset(size), map_location="cpu", weights_only=True)
    assert saved["step"] == int(orbax_states[size]["step"]) == STEPS[size]
    assert all(t.dtype == torch.float32 for t in saved["ema"].values())
    assert sum(t.numel() for t in saved["ema"].values()) == EMA_FLOATS[size]
    _tree_equal(state_dict_to_flax(saved["ema"]), jax.device_get(orbax_states[size]["ema"]["params"]))


@pytest.mark.parametrize("size", [32, 64])
def test_converted_weights_give_the_jax_score(orbax_states, size):
    jconfig, config = jax_scale_config(size), texture64_haar_scale_config(size)
    config.data.base_dir = DATASETS
    batch = next(PKLDataModule(config).test_iterator(batch_size=2))
    jtask = jax_create_task(jconfig, None)
    jtask.reconfigure(STEPS[size])
    task, model, step = multiscale._load_scale(config, "cpu")
    assert step == STEPS[size]
    t = np.full((2,), 0.5, np.float32)
    rng = np.random.RandomState(size)
    noisy = {}
    for k in ("x", "y"):
        std = task.sde[k].marginal_prob(torch.from_numpy(batch[k]), torch.from_numpy(t))[1].numpy()
        noisy[k] = (batch[k] + std[:, None, None, None] * rng.randn(*batch[k].shape)).astype(np.float32)
    try:
        module, _ = init_model_shapes_only(jconfig, jax.random.key(0))
        jscore = jax_wrappers.get_conditional_score_fn(
            jax_wrappers.get_score_fn(jtask.sde, module, orbax_states[size]["ema"]["params"], conditional=True,
                                      train=False, continuous=True),
            "x",
        )
        want = np.asarray(jax.jit(jscore)(noisy["x"], noisy["y"], t))
    finally:
        reset_jax_dispatch()
    tscore = get_conditional_score_fn(get_score_fn(task.sde, model, conditional=True, train=False, continuous=True), "x")
    with torch.no_grad():
        got = tscore(*(torch.from_numpy(a) for a in (noisy["x"], noisy["y"], t))).numpy()
    assert got.shape == want.shape == (2, size // 2, size // 2, 9)
    assert np.abs(got - want).max() <= SCORE_REL_TOL * np.abs(want).max()


def test_three_step_chain_matches_jax(tmp_path):
    from conditional_score_diffusion_tpu.eval.multiscale import run_multi_scale_test as jax_chain

    jmaster = jax_master_config()
    for key, size in (("scale_32", 32), ("scale_64", 64)):
        jmaster[key].model.checkpoint_path = checkpoint(size)
        jmaster[key].data.base_dir = DATASETS
    try:
        want = jax_chain(jmaster, str(tmp_path / "jax"), p_steps=3)[0]
    finally:
        reset_jax_dispatch()
    master = texture64_multiscale_master_config()
    for config in multiscale.scale_configs(master):
        config.data.base_dir = DATASETS
    shapes = [((8, s // 2, s // 2, 9), (8, s // 2, s // 2, 3)) for s in (32, 64)]
    noise = Replay(chain_draws(42, shapes, 3))
    got = multiscale.run_multi_scale_test(master, str(tmp_path / "port"), p_steps=3, device="cpu", noise=noise)[0]
    assert not noise.draws
    assert got.shape == want.shape == (8, 64, 64, 3)
    assert np.abs(got - want).max() <= CHAIN_REL_TOL * np.abs(want).max()
    metrics = {}
    for side in ("jax", "port"):
        with open(tmp_path / side / "multi_scale" / "metrics.json") as f:
            metrics[side] = json.load(f)
    assert sorted(metrics["port"]) == sorted(metrics["jax"])
    for k, v in metrics["jax"].items():
        if isinstance(v, float):
            assert abs(metrics["port"][k] - v) <= METRIC_REL_TOL * abs(v), k


def test_block_variant_calls_per_forward_are_chip_smokes():
    """The `_block` pyramid's kernel calls per forward of each scale on the
    meta device, against `chip_smoke.py`'s constants, at the sites it
    checks; the pyramid without the knobs calls no kernel."""
    import chip_smoke

    calls = chip_smoke.chain_calls(texture64_multiscale_master_block_config())
    assert sorted(calls) == [32, 64]
    for c in calls.values():
        assert chip_smoke.per_name(c) == chip_smoke.PYRAMID_PER_FORWARD
        assert set(chip_smoke.sites(c, "gn_silu_conv3x3")) <= set(chip_smoke.CHAIN_TAIL_SHAPES)
        assert set(chip_smoke.sites(c, "resblock_fused", "resblock_fused_split")) <= set(chip_smoke.CHAIN_BLOCK_SHAPES)
    off = chip_smoke.chain_calls(texture64_multiscale_master_config())
    assert all(not c for c in off.values())
