"""The committed EMA file of the trained texture64 checkpoint against the
orbax checkpoint it was converted from, and its score against JAX's.

`conditional_score_diffusion_tpu_torch/assets/texture64_sr_cmde_ema_40000.pt`
(written by `tests/_torch_port_convert_texture64.py`) must hold the
checkpoint's EMA bit for bit, leaf by leaf, in float32.  The port's model
with it (the harness's loader, the port's test recipe) must give the JAX
model's conditional score with the checkpoint's EMA on 2 test images at
t = 0.5 within 5e-4 of the score's largest magnitude (a same-weights
forward; the port's recipe has the fused tail on, its plain version here).
"""

import os
import sys

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from _torch_port_toy import reset_jax_dispatch  # noqa: E402
from configs.artifacts.texture64_sr_cmde_test import get_config as jax_test_config
from conditional_score_diffusion_tpu.models import init_model_shapes_only
from conditional_score_diffusion_tpu.models import wrappers as jax_wrappers
from conditional_score_diffusion_tpu.sde import build_sde as jax_build_sde
from conditional_score_diffusion_tpu_torch.configs import texture64_sr_cmde_test_config
from conditional_score_diffusion_tpu_torch.configs.texture64_sr_cmde_test import EMA_ASSET
from conditional_score_diffusion_tpu_torch.data.pkl_datasets import iter_test_batches
from conditional_score_diffusion_tpu_torch.eval.harness import load_model
from conditional_score_diffusion_tpu_torch.models.convert import state_dict_to_flax
from conditional_score_diffusion_tpu_torch.models.wrappers import get_conditional_score_fn, get_score_fn
from conditional_score_diffusion_tpu_torch.sde import build_sde

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(REPO, "artifacts", "texture64_run", "texture64", "checkpoints", "40000", "default")
EMA_FLOATS = 13_644_550  # the EMA's parameters (its _METADATA adds decay and num_updates)
SCORE_REL_TOL = 5e-4


@pytest.fixture(scope="module")
def orbax_state():
    """The checkpoint as orbax stored it (nested dicts of arrays)."""
    return ocp.StandardCheckpointer().restore(CHECKPOINT)


def _tree_equal(got, want, path=()):
    assert sorted(got) == sorted(want), path
    for k in want:
        if isinstance(want[k], dict):
            _tree_equal(got[k], want[k], path + (k,))
        else:
            w = np.asarray(want[k])
            assert got[k].dtype == w.dtype == np.float32 and np.array_equal(got[k], w), path + (k,)


def test_committed_ema_equals_the_checkpoint_bit_for_bit(orbax_state):
    saved = torch.load(EMA_ASSET, map_location="cpu", weights_only=True)
    assert saved["step"] == int(orbax_state["step"]) == 40000
    assert all(t.dtype == torch.float32 for t in saved["ema"].values())
    assert sum(t.numel() for t in saved["ema"].values()) == EMA_FLOATS
    _tree_equal(state_dict_to_flax(saved["ema"]), jax.device_get(orbax_state["ema"]["params"]))


def test_converted_weights_give_the_jax_score(orbax_state):
    jconfig = jax_test_config()
    config = texture64_sr_cmde_test_config()
    config.data.base_dir = jconfig.data.base_dir = os.path.join(REPO, "datasets")
    batch = next(iter_test_batches(config, batch_size=2))
    rng = np.random.RandomState(0)
    t = np.full((2,), 0.5, np.float32)
    tsde, _ = build_sde(config)
    noisy = {}
    for k in ("x", "y"):
        std = tsde[k].marginal_prob(torch.from_numpy(batch[k]), torch.from_numpy(t))[1].numpy()
        noisy[k] = (batch[k] + std[:, None, None, None] * rng.randn(*batch[k].shape)).astype(np.float32)

    try:
        module, _ = init_model_shapes_only(jconfig, jax.random.key(0))
        jsde, _ = jax_build_sde(jconfig)
        jscore = jax_wrappers.get_conditional_score_fn(
            jax_wrappers.get_score_fn(jsde, module, orbax_state["ema"]["params"], conditional=True, train=False,
                                      continuous=True),
            "x",
        )
        want = np.asarray(jax.jit(jscore)(noisy["x"], noisy["y"], t))
    finally:
        reset_jax_dispatch()

    model, step = load_model(config, "cpu")
    assert step == 40000
    tscore = get_conditional_score_fn(
        get_score_fn(tsde, model, conditional=True, train=False, continuous=True), "x"
    )
    with torch.no_grad():
        got = tscore(*(torch.from_numpy(a) for a in (noisy["x"], noisy["y"], t)))
    assert got.shape == want.shape == (2, 64, 64, 3)
    err = np.abs(got.numpy() - want).max()
    assert err <= SCORE_REL_TOL * np.abs(want).max(), (err, np.abs(want).max())


def test_harness_tail_calls_per_forward():
    """`chip_smoke.py` counts the fused tail's calls in one forward of the
    texture64 harness on the meta device: the 17 blocks at 16x16 and below
    (2 down, 3 up at 16x16x128 and at 8x8x128; 2 down, 2 mid, 3 up at
    4x4x192), at the shapes its kernel phase checks."""
    import chip_smoke

    calls = chip_smoke.sites(
        chip_smoke.forward_calls(chip_smoke.harness_config(""), chip_smoke.HARNESS_BATCH), "gn_silu_conv3x3"
    )
    assert calls == {(16, 128): 5, (8, 128): 5, (4, 192): 7}


def test_texture64_test_split_is_the_jax_split(monkeypatch):
    """The recipe's test split (General_PKLDataset, 4x SR degradation,
    batch 16) as the JAX harness iterates it, batch by batch: exactly with
    the JAX assembler's numpy path, the one the port copies.  Its C++
    extension scales by 1/255 as a product: x within one float32 ulp, y
    (x through the bicubic degradation) within 1e-6."""
    from conditional_score_diffusion_tpu.data import create_datamodule
    from conditional_score_diffusion_tpu.data import native as jax_native

    jconfig, config = jax_test_config(), texture64_sr_cmde_test_config()
    jconfig.data.base_dir = config.data.base_dir = os.path.join(REPO, "datasets")
    got = list(iter_test_batches(config))

    def jax_batches():
        module = create_datamodule(jconfig)
        module.setup()
        return list(module.test_iterator())

    with_extension = jax_batches()
    monkeypatch.setattr(jax_native, "load_native", lambda: None)
    exact = jax_batches()
    assert len(got) == len(exact) == len(with_extension) == 20
    for g, w, e in zip(got, exact, with_extension):
        for k in ("x", "y"):
            assert g[k].shape == (16, 64, 64, 3) and g[k].dtype == np.float32
            assert np.array_equal(g[k], w[k]), k
        np.testing.assert_allclose(g["x"], e["x"], rtol=1.2e-7, atol=0)
        np.testing.assert_allclose(g["y"], e["y"], rtol=0, atol=1e-6)
