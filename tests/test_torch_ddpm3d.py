"""The port's 3-D DDPM (`models/ddpm3d.py`) against the JAX package's, on the
MRI->PET volume recipe (`mri_to_pet_config(volumetric=True)`) cut to toy
size: volumes 16x16x8 of one channel, nf 8, ch_mult (1, 2), one resblock a
level, dropout 0; weights redrawn with numpy and carried over by the
Flax->torch converter (DHWIO -> OIDHW).

* same-weights forwards of ``ddpm3D_paired`` and ``ddpm3D_paired_SR3``,
  with the stride-2 conv resampling and with the average pool, at 5e-4 of
  the output's largest magnitude (the README's bound for a forward);
* the converter's round trip, bit for bit;
* a 3-step conditional PC sampler on the JAX key chain's noise at 1e-4 of
  its result's largest magnitude;
* one multi-speed DSM loss on the JAX draws at 1e-5 relative;
* the kernel gates refuse a volume, in both packages, and a 3-D block with
  ``fused_tail`` and ``fused_block`` set calls no kernel wrapper;
* the ``paired3D`` callback on the toy 3-D model: finite frames and scalar.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_port_toy import Replay, jax_loss_draws, jax_sampler_draws, randomize_params, reset_jax_dispatch, to_torch
from conditional_score_diffusion_tpu.configs.extra import mri_to_pet_config as jax_mri_to_pet_config
from conditional_score_diffusion_tpu.losses import build_loss_fn as jax_build_loss_fn
from conditional_score_diffusion_tpu.models import init_model_shapes_only
from conditional_score_diffusion_tpu.models import layers as jax_layers
from conditional_score_diffusion_tpu.sampling import pc as jax_pc
from conditional_score_diffusion_tpu.sde import build_sde as jax_build_sde
from conditional_score_diffusion_tpu_torch.configs import mri_to_pet_config
from conditional_score_diffusion_tpu_torch.losses import build_loss_fn
from conditional_score_diffusion_tpu_torch.models import create_model, layers
from conditional_score_diffusion_tpu_torch.models.convert import flax_to_state_dict, state_dict_to_flax
from conditional_score_diffusion_tpu_torch.sampling import get_conditional_sampling_fn
from conditional_score_diffusion_tpu_torch.sde import build_sde

torch.set_num_threads(1)

FORWARD_TOL, SAMPLER_TOL, LOSS_RTOL = 5e-4, 1e-4, 1e-5
SHAPE = (2, 16, 16, 8, 1)


def shrink(config, approach_sr3=False, resamp_with_conv=True):
    d, m = config.data, config.model
    d.image_size = d.effective_image_size = 16
    d.shape_x, d.shape_y = [1, 16, 16, 8], [1, 16, 16, 8]
    m.nf, m.ch_mult, m.num_res_blocks, m.dropout = 8, (1, 2), 1, 0.0
    m.resamp_with_conv = resamp_with_conv
    return config


def toy(approach="ours_DV", resamp_with_conv=True, seed=1):
    """The JAX and port recipes, the JAX module, its numpy params and the
    port model holding them."""
    jconfig = shrink(jax_mri_to_pet_config(True, approach), resamp_with_conv=resamp_with_conv)
    tconfig = shrink(mri_to_pet_config(True, approach), resamp_with_conv=resamp_with_conv)
    try:
        module, params = init_model_shapes_only(jconfig, jax.random.key(0))
    finally:
        reset_jax_dispatch()
    params = randomize_params(jax.device_get(params), seed)
    model = create_model(tconfig, device="cpu")
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return jconfig, tconfig, module, params, model


def volumes(seed=0):
    rng = np.random.RandomState(seed)
    return rng.rand(*SHAPE).astype(np.float32), rng.rand(*SHAPE).astype(np.float32)


@pytest.mark.parametrize("approach", ["ours_DV", "sr3"])
@pytest.mark.parametrize("resamp_with_conv", [True, False])
def test_forward_matches_jax(approach, resamp_with_conv):
    jconfig, tconfig, module, params, model = toy(approach, resamp_with_conv)
    assert type(model).__name__ == ("DDPM3DPairedSR3" if approach == "sr3" else "DDPM3DPaired")
    x, y = volumes()
    t = np.array([0.3, 0.8], np.float32)
    fn = jax.jit(lambda p, a, b: module.apply({"params": p}, a, b, train=False))
    want = fn(params, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, jnp.asarray(t))
    with torch.no_grad():
        got = model({"x": torch.from_numpy(x), "y": torch.from_numpy(y)}, torch.from_numpy(t))
    if approach == "sr3":
        want, got = {"x": want}, {"x": got}
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape == SHAPE
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=FORWARD_TOL * np.abs(w).max())


def test_converter_round_trip_is_exact():
    _, _, _, params, model = toy()
    back = state_dict_to_flax(model.state_dict())
    flat = lambda tree, p=(): sum(  # noqa: E731
        (flat(v, p + (k,)) if isinstance(v, dict) else [(p + (k,), v)] for k, v in tree.items()), []
    )
    want, got = dict(flat(params)), dict(flat(back))
    assert sorted(got) == sorted(want)
    assert any(v.ndim == 5 for v in want.values())
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    assert model.state_dict()["unet.conv_in.weight"].shape == (8, 2, 3, 3, 3)


def test_three_step_sampler_matches_jax():
    """The conditional PC sampler (conditional_reverse_diffusion +
    conditional_langevin) for 3 steps on the toy volume model."""
    jconfig, tconfig, module, params, model = toy()
    _, y = volumes(3)
    p_steps, key = 3, jax.random.key(5)
    jsde, eps = jax_build_sde(jconfig)
    try:
        fn = jax_pc.get_conditional_sampling_fn(jconfig, jsde, SHAPE, eps, module, p_steps=p_steps)
        want, info = fn(key, params, jnp.asarray(y))
        want = np.asarray(want)
    finally:
        reset_jax_dispatch()
    tsde, teps = build_sde(tconfig)
    noise = Replay(jax_sampler_draws(key, p_steps, SHAPE, False))
    got, tinfo = get_conditional_sampling_fn(tconfig, tsde, SHAPE, teps, p_steps=p_steps)(noise, model, torch.from_numpy(y))
    assert not noise.draws and tinfo["steps"] == info["steps"] == 2 * p_steps
    assert got.shape == SHAPE and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SAMPLER_TOL * np.abs(want).max())


def test_dsm_loss_matches_jax():
    """The multi-speed loss (x and y diffused at one t) of the VS-CMDE
    recipe at step 0, train mode, dropout 0."""
    jconfig, tconfig, module, params, model = toy(seed=2)
    x, y = volumes(4)
    batch = {"x": x, "y": y}
    jsde, _ = jax_build_sde(jconfig)
    rng = jax.random.key(6)
    try:
        want = float(jax.jit(lambda p: jax_build_loss_fn(jconfig, module, jsde, train=True)(p, jsde, batch, rng))(params))
    finally:
        reset_jax_dispatch()
    draws = jax_loss_draws(rng, {k: v.shape for k, v in batch.items()})
    sde = build_sde(tconfig)[0]
    model.train()
    t = torch.from_numpy(np.array(draws.pop("t")))
    got = build_loss_fn(tconfig, model, sde, train=True)(sde, to_torch(batch), t=t, noise=to_torch(draws)).item()
    assert abs(got - want) <= LOSS_RTOL * abs(want), (got, want)


def test_gates_refuse_a_volume(monkeypatch):
    """JAX gates on ``dim == 2``; so do the port's.  A 3-D resblock with both
    knobs set, in eval mode without a gradient, takes its plain path: no
    kernel wrapper is called (each raises here)."""
    x = torch.zeros(2, 4, 4, 4, 32)
    skip = torch.zeros(2, 4, 4, 4, 32)
    assert layers.fused_block_applicable(x[..., 0, :], F.silu, False, None, 32, True)
    assert not layers.fused_block_applicable(x, F.silu, False, None, 32, True, dim=3)
    assert not layers.fused_split_block_applicable(x, skip, F.silu, False, 32, True, dim=3)
    jx = jnp.zeros(x.shape)
    try:
        jax_layers.set_fused_block_dispatch(jax_layers.fused_block_candidate_policy)
        assert not jax_layers.fused_block_applicable(jx, None, jax.nn.silu, False, None, 3, 32)
        assert not jax_layers.fused_split_block_applicable(jx, jx, jax.nn.silu, False, 3, 32)
    finally:
        reset_jax_dispatch()

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper was called on a volume")

    for name in ("gn_silu_conv3x3", "resblock_fused", "resblock_fused_split"):
        monkeypatch.setattr(layers, name, refuse)
    for split in (False, True):
        block = layers.ResnetBlockDDPM(
            F.silu, 64 if split else 32, 32, temb_dim=16, conv_shortcut=True, split_skip=split,
            fused_tail=True, fused_block=True, dim=3,
        ).eval()
        with torch.no_grad():
            out = block(x, torch.zeros(2, 16), skip=skip if split else None)
        assert out.shape == x.shape
    same = layers.ResnetBlockDDPM(F.silu, 32, 32, temb_dim=16, fused_tail=True, fused_block=True, dim=3).eval()
    with torch.no_grad():
        assert same(x, torch.zeros(2, 16)).shape == x.shape


def test_paired3d_callback_samples_the_3d_model(tmp_path):
    """The ``paired3D`` callback on the toy ``ddpm3D_paired`` (3 steps): the
    reconstruction scalar and the frames of each axis are finite."""
    import types

    from conditional_score_diffusion_tpu_torch.training import callbacks

    _, tconfig, _, _, model = toy()
    tconfig.model.num_scales = 3
    tconfig.training.visualization_freq = 3
    x, y = volumes(7)

    class Data:
        def val_iterator(self, batch_size):
            yield {"x": x[:batch_size], "y": y[:batch_size]}

    class Writer:
        def __init__(self):
            self.records = {}

        def add_scalar(self, tag, value, step):
            self.records[tag] = np.asarray(value)

        add_image = add_scalar

    writer = Writer()
    trainer = types.SimpleNamespace(
        state=types.SimpleNamespace(model=model, ema=types.SimpleNamespace(params=dict(model.named_parameters()))),
        writer=writer, datamodule=Data(), device=torch.device("cpu"),
        callback_noise=lambda step: torch.Generator().manual_seed(step),
    )
    callbacks.paired3d_visualization_callback(tconfig, "train")(trainer, 6)
    names = ("axial", "coronal", "sagittal")
    assert sorted(writer.records) == sorted(
        ["val_rec_loss_pc"] + [f"paired3D_{n}" for n in names] + [f"paired_video_dim_{n}/filmstrip" for n in names]
    )
    for tag, value in writer.records.items():
        assert np.isfinite(value).all(), tag
    assert 0.0 < float(writer.records["val_rec_loss_pc"]) < 1.0
