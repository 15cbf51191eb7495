"""The port's `ddpm_paired` against the JAX one on the same weights.

The JAX toy model's params (`init_model` with ``model.fused_tail = True``,
then every leaf redrawn by numpy so no conv is zero) go through
`models/convert.py`; both forwards run in eval mode on the same inputs, once
with the fused tail on in both frameworks (JAX: Pallas in interpret mode;
port: the plain version a CPU tensor takes) and once with it off.
Tolerance 5e-4, the JAX package's bound for a same-weights forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_toy import (
    jax_toy_config,
    randomize_params,
    reset_jax_dispatch,
    toy_inputs,
    torch_toy_config,
)
from conditional_score_diffusion_tpu.models import init_model
from conditional_score_diffusion_tpu.models import layers as jax_layers
from conditional_score_diffusion_tpu_torch.models import create_model
from conditional_score_diffusion_tpu_torch.models.convert import flax_to_state_dict, state_dict_to_flax

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_model():
    try:
        module, params = init_model(jax_toy_config(fused_tail=True), jax.random.key(0))
    finally:
        reset_jax_dispatch()
    return module, randomize_params(jax.device_get(params))


def _tree_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _tree_equal(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("fused_tail", [True, False])
def test_forward_matches_jax(jax_model, fused_tail):
    module, params = jax_model
    x, y, t = toy_inputs()
    labels = t * 999
    try:
        if fused_tail:
            jax_layers.set_fused_gn_conv_dispatch(jax_layers.fused_tail_candidate_policy)
        forward = jax.jit(lambda p, x, y, c: module.apply({"params": p}, {"x": x, "y": y}, c, train=False))
        want = jax.device_get(forward(params, x, y, labels))
    finally:
        reset_jax_dispatch()

    model = create_model(torch_toy_config(fused_tail), device="cpu")
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    tails = [m for m in model.modules() if hasattr(m, "gn_act_conv_tail")]
    assert all(m.fused_tail == fused_tail for m in tails) and len(tails) == 11
    with torch.no_grad():
        got = model({"x": torch.from_numpy(x), "y": torch.from_numpy(y)}, torch.from_numpy(labels))
    for k in ("x", "y"):
        assert got[k].shape == (2, 32, 32, 3)
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=5e-4, atol=5e-4)


def test_flax_torch_flax_round_trip_is_exact(jax_model):
    _, params = jax_model
    model = create_model(torch_toy_config(True), device="cpu")
    state_dict = flax_to_state_dict(params)
    model.load_state_dict(state_dict, strict=True)  # every key and shape fits
    _tree_equal(state_dict_to_flax(model.state_dict()), params)


def test_fused_tail_fires_where_the_jax_gate_does():
    """In eval mode the gate fires on the tails at 16x16 and 8x8 and not at
    32x32 (8 of the toy model's 11 resblocks); in train mode never."""
    from conditional_score_diffusion_tpu_torch.models import layers

    model = create_model(torch_toy_config(True), device="cpu")
    calls = []
    real = layers.gn_silu_conv3x3

    def spy(h, *args, **kwargs):
        calls.append(tuple(h.shape))
        return real(h, *args, **kwargs)

    layers.gn_silu_conv3x3 = spy
    try:
        x, y, t = toy_inputs()
        with torch.no_grad():
            model({"x": torch.from_numpy(x), "y": torch.from_numpy(y)}, torch.from_numpy(t))
        model.train()
        model({"x": torch.from_numpy(x), "y": torch.from_numpy(y)}, torch.from_numpy(t))
    finally:
        layers.gn_silu_conv3x3 = real
    # down_1_0, up_1_0, up_1_1 at 16x16; down_2_0, mid_block0/1, up_2_0, up_2_1 at 8x8
    assert sorted(calls) == sorted([(2, 16, 16, 64)] * 3 + [(2, 8, 8, 64)] * 5), calls
