"""The port's `ddpm_2xSR`, `ddpm_SR`, `ddpm_KxSR` and `ddpm_multi_speed_haar`
against the JAX models on the same weights.

Each variant's JAX recipe (`configs/srflow.py`: the celebA-HQ-160 bicubic
chain's scale for the 2x models, the direct 8x recipe for ``ddpm_KxSR``)
and the port's copy are cut to toy size alike; the JAX params (every leaf
redrawn by numpy) go through `models/convert.py`; both forwards run in eval
mode on the same seeded inputs.  Tolerance 5e-4 of the output's largest
magnitude, the JAX package's bound for a same-weights forward (DDPM
forwards agree to ~1e-5).  The port's fused tail and block switched on
(their plain versions on a CPU tensor) give the same outputs within 2e-5.
The recipes themselves are held field by field against JAX.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from _torch_port_toy import randomize_params, reset_jax_dispatch  # noqa: E402
from conditional_score_diffusion_tpu.configs import srflow as jax_srflow  # noqa: E402
from conditional_score_diffusion_tpu.models import get_model as jax_get_model  # noqa: E402
from conditional_score_diffusion_tpu_torch.configs import Config  # noqa: E402
from conditional_score_diffusion_tpu_torch.configs import srflow  # noqa: E402
from conditional_score_diffusion_tpu_torch.models import create_model  # noqa: E402
from conditional_score_diffusion_tpu_torch.models.convert import flax_to_state_dict  # noqa: E402

torch.set_num_threads(1)

TOL = 5e-4
FUSED_TOL = 2e-5


def _shrink(config, size, scale):
    """A toy recipe: x at ``size``, nf 16, ch_mult (1, 2), one resblock a
    level, attention at the lower level."""
    d, m = config.data, config.model
    d.image_size = d.target_resolution = size
    m.nf, m.ch_mult, m.num_res_blocks, m.dropout = 16, (1, 2), 1, 0.0
    if m.name in ("ddpm_2xSR", "ddpm_SR"):
        d.effective_image_size = size // 2
        d.shape_x, d.shape_y = [3, size, size], [3, size // 2, size // 2]
        m.attn_resolutions = (size // 4,)
    else:
        d.effective_image_size = size
        d.scale = scale
        d.shape_x, d.shape_y = [3, size, size], [3, size, size]
        m.attn_resolutions = (size // 2,)
    return config


def _recipes(name):
    if name in ("ddpm_2xSR", "ddpm_SR"):
        pair = [jax_srflow.hq160_sequential_config(40, "bicubic"), srflow.hq160_sequential_config(40, "bicubic")]
    elif name == "ddpm_KxSR":
        pair = [jax_srflow.hq160_direct_8x_config(), srflow.hq160_direct_8x_config()]
    else:
        pair = [jax_srflow.hq160_sequential_config(40, "bicubic"), srflow.hq160_sequential_config(40, "bicubic")]
    for c in pair:
        c.model.name = name
        _shrink(c, 16, 4)
        if name == "ddpm_multi_speed_haar":
            c.model.input_channels = c.model.output_channels = 3
            c.data.max_haar_depth = 2
    return pair


def _inputs(name, seed=0):
    rng = np.random.RandomState(seed)
    t = rng.uniform(0.05, 1.0, size=(2,)).astype(np.float32) * 999
    if name == "ddpm_multi_speed_haar":
        from conditional_score_diffusion_tpu_torch.ops.haar import haar_forward

        img = torch.from_numpy(rng.rand(2, 16, 16, 3).astype(np.float32))
        z1 = haar_forward(img)
        z2 = haar_forward(z1[..., :3])
        return {"d1": z1[..., 3:].numpy(), "d2": z2[..., 3:].numpy(), "a2": z2[..., :3].numpy()}, t
    y_size = {"ddpm_KxSR": 4}.get(name, 8)
    x = rng.rand(2, 16, 16, 3).astype(np.float32)
    y = rng.rand(2, y_size, y_size, 3).astype(np.float32)
    return {"x": x, "y": y}, t


@pytest.mark.parametrize("name", ["ddpm_2xSR", "ddpm_SR", "ddpm_KxSR", "ddpm_multi_speed_haar"])
def test_variant_forward_matches_jax(name):
    jconfig, config = _recipes(name)
    inputs, t = _inputs(name)
    try:
        module = jax_get_model(name).from_config(jconfig)
        jinputs = {k: jnp.asarray(v) for k, v in inputs.items()}
        params = module.init({"params": jax.random.key(0), "dropout": jax.random.key(1)}, jinputs, jnp.asarray(t),
                             train=False)["params"]
        params = randomize_params(jax.device_get(params), seed=3)
        want = jax.device_get(jax.jit(lambda p: module.apply({"params": p}, jinputs, jnp.asarray(t), train=False))(params))
    finally:
        reset_jax_dispatch()

    outs = []
    for fused in (False, True):
        config.model.fused_tail = config.model.fused_block = fused
        model = create_model(config, device="cpu")
        model.load_state_dict(flax_to_state_dict(params), strict=True)
        with torch.no_grad():
            outs.append(model({k: torch.from_numpy(v) for k, v in inputs.items()}, torch.from_numpy(t)))
    got, got_fused = outs
    assert sorted(got) == sorted(want) == sorted(inputs if name == "ddpm_multi_speed_haar" else ("x", "y"))
    for k in want:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        top = np.abs(w).max()
        assert np.abs(got[k].numpy() - w).max() <= TOL * top, (k, np.abs(got[k].numpy() - w).max(), top)
        assert (got_fused[k] - got[k]).abs().max().item() <= FUSED_TOL * top, k
    if name != "ddpm_multi_speed_haar":
        assert got["y"].shape == inputs["y"].shape and got["x"].shape == inputs["x"].shape


def _leaves(config, prefix=""):
    for key, value in vars(config).items():
        if isinstance(value, Config):
            yield from _leaves(value, prefix + key + ".")
        else:
            yield prefix + key, value


def _jax_value(config, path):
    node = config
    for key in path.split("."):
        node = node[key]
    return node


def _hold_recipe(port, jax_config):
    leaves = dict(_leaves(port))
    for path, value in leaves.items():
        want = _jax_value(jax_config, path)
        if isinstance(value, (tuple, list)):
            assert list(value) == list(want), path
        else:
            assert value == want and type(value) is type(want), (path, value, want)
    return leaves


RECIPES = (
    [(f"hq160_{s}_{sp}", lambda s=s, sp=sp: (srflow.hq160_sequential_config(s, sp),
                                             jax_srflow.hq160_sequential_config(s, sp)))
     for s in (40, 80, 160) for sp in ("haar", "bicubic")]
    + [(f"df2k_{k}", lambda k=k: (srflow.df2k_config(k), jax_srflow.df2k_config(k))) for k in ("80to160", "40to80")]
    + [("hq160_direct_8x", lambda: (srflow.hq160_direct_8x_config(), jax_srflow.hq160_direct_8x_config()))]
)


@pytest.mark.parametrize("make", [r[1] for r in RECIPES], ids=[r[0] for r in RECIPES])
def test_srflow_recipe_matches_jax(make):
    """Every field of the port's recipe holds the JAX recipe's value."""
    port, jax_config = make()
    leaves = _hold_recipe(port, jax_config)
    assert "model.name" in leaves and "data.shape_x" in leaves
