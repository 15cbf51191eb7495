"""The port's `ddpm_paired` with the whole-resblock kernels on
(``model.fused_block``) and in bfloat16 (``compute_dtype``) against the JAX
model, on the same weights.

The toy is the flagship recipe at 32px with ch_mult (1, 2, 3)
(`_torch_port_toy.BLOCK_CH_MULT`): at 8x8 the block gate fires on a
mix-shortcut block, two identity blocks and two split blocks (one of them on
160 channels with a group straddling the concat), and the tail gate on
three 16x16 blocks.  JAX runs its Pallas kernels in interpret mode, the port
the plain versions a CPU tensor takes.

Tolerances: float32 forward 5e-4, the JAX package's bound for a
same-weights forward (measured 7e-6).  bfloat16: the two frameworks round to
bfloat16 at other places (one bfloat16 step is 2**-8 = 3.9e-3) and sum in
another order, and the network compounds it over its depth, so the score is
held at 3e-2 of its largest magnitude (measured 1.7e-2), and the 3-step
sample with the JAX key chain's noise at 1e-3 of its largest magnitude
(measured 6.0e-4: the prior noise, which both share exactly, dominates it
after 3 of 1000 steps).  The fused and unfused bfloat16 tails differ by
1.9e-2 of the score's largest magnitude, within the same 3e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_toy import (
    BLOCK_CH_MULT,
    Replay,
    jax_sampler_draws,
    jax_toy_config,
    randomize_params,
    reset_jax_dispatch,
    toy_inputs,
    torch_toy_config,
)
from conditional_score_diffusion_tpu.models import init_model
from conditional_score_diffusion_tpu.models import layers as jax_layers
from conditional_score_diffusion_tpu.models import wrappers as jax_wrappers
from conditional_score_diffusion_tpu.ops import fused_block_pallas as jax_fused
from conditional_score_diffusion_tpu.sampling import pc as jax_pc
from conditional_score_diffusion_tpu.sde import build_sde as jax_build_sde
from conditional_score_diffusion_tpu_torch.models import create_model
from conditional_score_diffusion_tpu_torch.models import layers
from conditional_score_diffusion_tpu_torch.models.convert import flax_to_state_dict, state_dict_to_flax
from conditional_score_diffusion_tpu_torch.models.wrappers import get_conditional_score_fn, get_score_fn
from conditional_score_diffusion_tpu_torch.sampling import get_pc_conditional_sampler
from conditional_score_diffusion_tpu_torch.sde import build_sde

torch.set_num_threads(1)

BF16_SCORE_REL_TOL = 3e-2
BF16_SAMPLE_REL_TOL = 1e-3


def _jax_config(fused=True):
    return jax_toy_config(fused_tail=fused, fused_block=fused, ch_mult=BLOCK_CH_MULT)


def _torch_config(fused=True):
    return torch_toy_config(fused_tail=fused, fused_block=fused, ch_mult=BLOCK_CH_MULT)


def _set_jax_dispatch():
    jax_layers.set_fused_gn_conv_dispatch(jax_layers.fused_tail_candidate_policy)
    jax_layers.set_fused_block_dispatch(jax_layers.fused_block_candidate_policy)


@pytest.fixture(scope="module")
def jax_model():
    try:
        module, params = init_model(_jax_config(), jax.random.key(0))
    finally:
        reset_jax_dispatch()
    return module, randomize_params(jax.device_get(params))


def _torch_model(params, fused=True):
    model = create_model(_torch_config(fused), device="cpu")
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return model


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(dict(v), f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.shape(v)
    return out


def test_fused_block_keeps_the_parameter_tree(jax_model):
    """The JAX model with the block kernels on declares the unfused model's
    tree, the converter carries it across unchanged, and the port's module
    with ``fused_block`` holds the same state_dict keys as without."""
    _, params = jax_model
    try:
        _, unfused = init_model(_jax_config(fused=False), jax.random.key(0))
    finally:
        reset_jax_dispatch()
    assert _flat(params) == _flat(jax.device_get(unfused))
    model = _torch_model(params)
    assert model.state_dict().keys() == create_model(_torch_config(False), device="cpu").state_dict().keys()
    back = _flat(state_dict_to_flax(model.state_dict()))
    assert back == _flat(params)
    for k, v in flax_to_state_dict(params).items():
        assert torch.equal(model.state_dict()[k], v), k


def test_forward_matches_jax(jax_model):
    module, params = jax_model
    x, y, t = toy_inputs()
    labels = t * 999
    try:
        _set_jax_dispatch()
        forward = jax.jit(lambda p, x, y, c: module.apply({"params": p}, {"x": x, "y": y}, c, train=False))
        want = jax.device_get(forward(params, x, y, labels))
    finally:
        reset_jax_dispatch()
    model = _torch_model(params)
    with torch.no_grad():
        got = model({"x": torch.from_numpy(x), "y": torch.from_numpy(y)}, torch.from_numpy(labels))
    for k in ("x", "y"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=5e-4, atol=5e-4)


def _spy(calls, kind, fn):
    def spy(x, *args, **kwargs):
        skip = args[0] if kind == "split" else None
        calls.append((kind, tuple(x.shape), None if skip is None else tuple(skip.shape)))
        return fn(x, *args, **kwargs)

    return spy


def test_block_gate_fires_where_the_jax_gate_does(jax_model, monkeypatch):
    """The same blocks take the block, split and tail kernels in both
    frameworks (JAX traced with `jax.eval_shape`), and none in train mode."""
    module, params = jax_model
    x, y, t = toy_inputs()
    jax_calls, torch_calls = [], []
    monkeypatch.setattr(jax_layers, "fused_resblock", _spy(jax_calls, "block", jax_layers.fused_resblock))
    monkeypatch.setattr(jax_layers, "fused_resblock_split", _spy(jax_calls, "split", jax_layers.fused_resblock_split))
    monkeypatch.setattr(jax_fused, "gn_silu_conv3x3_nhwc", _spy(jax_calls, "tail", jax_fused.gn_silu_conv3x3_nhwc))
    try:
        _set_jax_dispatch()
        jax.eval_shape(lambda p: module.apply({"params": p}, {"x": x, "y": y}, t, train=False), params)
    finally:
        reset_jax_dispatch()

    monkeypatch.setattr(layers, "resblock_fused", _spy(torch_calls, "block", layers.resblock_fused))
    monkeypatch.setattr(layers, "resblock_fused_split", _spy(torch_calls, "split", layers.resblock_fused_split))
    monkeypatch.setattr(layers, "gn_silu_conv3x3", _spy(torch_calls, "tail", layers.gn_silu_conv3x3))
    model = _torch_model(params)
    inputs = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    with torch.no_grad():
        model(inputs, torch.from_numpy(t))
    assert sorted(torch_calls) == sorted(jax_calls)
    assert sorted(torch_calls) == sorted(
        [("block", (2, 8, 8, 64), None)]  # down_2_0: 64 -> 96, NIN shortcut
        + [("block", (2, 8, 8, 96), None)] * 2  # mid_block0, mid_block1
        + [("split", (2, 8, 8, 96), (2, 8, 8, 96)), ("split", (2, 8, 8, 96), (2, 8, 8, 64))]
        + [("tail", (2, 16, 16, 64), None)] * 3  # down_1_0, up_1_0, up_1_1
    )
    torch_calls.clear()
    model.train()
    model(inputs, torch.from_numpy(t))
    assert torch_calls == []


def _scores(module, params):
    """The conditional bfloat16 score of both frameworks' models."""
    jsde, _ = jax_build_sde(_jax_config())
    tsde, _ = build_sde(_torch_config())
    jscore = jax_wrappers.get_conditional_score_fn(
        jax_wrappers.get_score_fn(
            jsde, module, params, conditional=True, train=False, continuous=True,
            compute_dtype=jnp.bfloat16,
        ),
        "x",
    )
    tscore = get_conditional_score_fn(
        get_score_fn(
            tsde, _torch_model(params), conditional=True, train=False, continuous=True,
            compute_dtype=torch.bfloat16,
        ),
        "x",
    )
    return jscore, tscore, jsde, tsde


def test_bf16_score_matches_jax(jax_model):
    """`get_score_fn(compute_dtype=bfloat16)` in both frameworks, block and
    tail kernels on; the port's caller module stays float32."""
    module, params = jax_model
    x, y, t = toy_inputs()
    jscore, tscore, _, _ = _scores(module, params)
    try:
        _set_jax_dispatch()
        want = np.asarray(jax.jit(jscore)(x * 20.0, y, t))
    finally:
        reset_jax_dispatch()
    got = tscore(torch.from_numpy(x * 20.0), torch.from_numpy(y), torch.from_numpy(t))
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = np.abs(got.numpy() - want).max()
    assert err <= BF16_SCORE_REL_TOL * np.abs(want).max(), (err, np.abs(want).max())


def test_bf16_sample_matches_jax(jax_model):
    """3 steps of the conditional PC sampler through the bench's composition
    (`bench.py`: get_score_fn(compute_dtype) -> get_conditional_score_fn ->
    get_pc_conditional_sampler), with the JAX key chain's noise injected."""
    module, params = jax_model
    _, y, _ = toy_inputs()
    p_steps, shape = 3, y.shape
    kw = dict(
        shape=shape, predictor="conditional_reverse_diffusion", corrector="conditional_langevin",
        snr=0.15, p_steps=p_steps, c_steps=1, denoise=True,
    )
    key = jax.random.key(3)
    jscore, tscore, jsde, tsde = _scores(module, params)
    _, eps = jax_build_sde(_jax_config())
    try:
        _set_jax_dispatch()
        sampler = jax_pc.get_pc_conditional_sampler(jsde, eps=eps, **kw)
        want, _ = jax.jit(lambda r: sampler(r, jscore, jnp.asarray(y)))(key)
        want = np.asarray(want)
    finally:
        reset_jax_dispatch()
    noise = Replay(jax_sampler_draws(key, p_steps, shape, use_path=False))
    got, _ = get_pc_conditional_sampler(tsde, eps=eps, **kw)(noise, tscore, torch.from_numpy(y))
    assert not noise.draws and got.dtype == torch.float32
    err = np.abs(got.numpy() - want).max()
    assert err <= BF16_SAMPLE_REL_TOL * np.abs(want).max(), (err, np.abs(want).max())


def test_tail_runs_under_bf16_parameters(jax_model):
    """With ``compute_dtype=bfloat16`` the parameters are bfloat16; the tail
    call site hands GroupNorm's vectors and conv1's bias over as float32,
    which the kernel's wrapper requires (it raised TypeError before), and
    the result is the unfused bfloat16 block's within bfloat16 rounding."""
    _, params = jax_model
    x, y, t = toy_inputs()
    inputs = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    outs = {}
    for fused_tail in (True, False):
        model = create_model(torch_toy_config(fused_tail, ch_mult=BLOCK_CH_MULT), device="cpu")
        model.load_state_dict(flax_to_state_dict(params), strict=True)
        fn = get_score_fn(
            build_sde(_torch_config())[0], model, conditional=True, continuous=True,
            compute_dtype=torch.bfloat16,
        )
        outs[fused_tail] = fn(inputs, torch.from_numpy(t))["x"]
        assert next(model.parameters()).dtype == torch.float32  # the caller's module is left as it is
    assert torch.isfinite(outs[True]).all()
    err = (outs[True] - outs[False]).abs().max().item()
    assert err <= BF16_SCORE_REL_TOL * outs[False].abs().max().item()


@pytest.mark.parametrize("path", ["block", "tail"])
def test_flagship_launch_counts_match_chip_smoke(monkeypatch, path):
    """The full-width flagship, run on the meta device with the kernel
    wrappers stubbed, takes the block, split and tail kernels as often per
    forward as `chip_smoke.py` expects them on each of its two paths."""
    import chip_smoke
    from conditional_score_diffusion_tpu_torch.configs import (
        texture160_sr_cmde_bf16_block_config,
        texture160_sr_cmde_config,
    )

    calls = {"resblock_fused": 0, "resblock_fused_split": 0, "gn_silu_conv3x3": 0}

    def stub(name):
        def fn(x, *args, **kwargs):
            calls[name] += 1
            cout = (kwargs.get("w0") if "w0" in kwargs else args[0]).shape[0]
            return torch.empty(*x.shape[:-1], cout, device=x.device, dtype=x.dtype)

        return fn

    for name in calls:
        monkeypatch.setattr(layers, name, stub(name))
    if path == "block":
        config, expected = texture160_sr_cmde_bf16_block_config(), chip_smoke.PER_FORWARD_BLOCK_PATH
    else:
        config, expected = texture160_sr_cmde_config(), chip_smoke.PER_FORWARD_TAIL_PATH
    model = create_model(config, device="meta")
    x = torch.empty(8, 160, 160, 3, device="meta")
    with torch.no_grad():
        model({"x": x, "y": x}, torch.empty(8, device="meta"))
    assert calls == {name: expected.get(name, 0) for name in calls}
