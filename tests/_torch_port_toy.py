"""Shared toy setup of the PyTorch-port parity tests (tests/test_torch_*.py).

The flagship CMDE recipe at toy size: 32px, nf=32, ch_mult (1, 2, 2), one
resblock per level, attention at 16.  The fused-tail gate (H*W <= 400) then
fires at 16x16 and 8x8 and is skipped at 32x32.  With ch_mult (1, 2, 3)
(`BLOCK_CH_MULT`) the whole-block gate (max(H, W) <= 10) fires at 8x8 on a
mix-shortcut block (64 -> 96), two identity blocks and two split blocks,
one of them on 96 + 64 = 160 channels whose 5-channel groups straddle the
concat boundary.  Inputs and weights are made with numpy from a seed and
handed to both frameworks.
"""

import jax
import numpy as np
import torch

TOY_SIZE = 32
BLOCK_CH_MULT = (1, 2, 3)


def shrink(config, ch_mult=(1, 2, 2)):
    """Cut a flagship recipe (ml_collections or the port's Config) to toy size."""
    s = TOY_SIZE
    config.data.image_size = s
    config.data.effective_image_size = s
    config.data.target_resolution = s
    config.data.shape_x = [3, s, s]
    config.data.shape_y = [3, s, s]
    config.model.nf = 32
    config.model.ch_mult = tuple(ch_mult)
    config.model.num_res_blocks = 1
    config.model.attn_resolutions = (16,)
    return config


def jax_toy_config(fused_tail: bool, fused_block: bool = False, ch_mult=(1, 2, 2)):
    from conditional_score_diffusion_tpu.configs.celeba_sr import celeba_sr_160_config

    config = shrink(celeba_sr_160_config("ours_NDV"), ch_mult)
    config.model.fused_tail = fused_tail
    config.model.fused_block = fused_block
    return config


def torch_toy_config(fused_tail: bool, fused_block: bool = False, ch_mult=(1, 2, 2)):
    from conditional_score_diffusion_tpu_torch.configs import celeba_sr_160_config

    config = shrink(celeba_sr_160_config("ours_NDV"), ch_mult)
    config.model.fused_tail = fused_tail
    config.model.fused_block = fused_block
    return config


def reset_jax_dispatch():
    """`create_model` sets process-global lowering policies in the JAX
    package; put them back to their defaults so no other test sees them."""
    from conditional_score_diffusion_tpu.models import layers

    layers.set_conv_dispatch(None)
    layers.set_fused_gn_conv_dispatch(None)
    layers.set_fused_block_dispatch(None)


def randomize_params(params, seed: int = 1):
    """Flax params (nested dicts) with every leaf redrawn by numpy: GroupNorm
    scales near 1, everything else N(0, 0.05).  Returns numpy arrays."""
    rng = np.random.RandomState(seed)

    def walk(tree):
        out = {}
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = walk(dict(v))
                continue
            shape = np.shape(v)
            if k == "scale":
                out[k] = (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
            else:
                out[k] = (0.05 * rng.randn(*shape)).astype(np.float32)
        return out

    return walk(dict(params))


def toy_inputs(batch: int = 2, seed: int = 0):
    rng = np.random.RandomState(seed)
    x = rng.rand(batch, TOY_SIZE, TOY_SIZE, 3).astype(np.float32)
    y = rng.rand(batch, TOY_SIZE, TOY_SIZE, 3).astype(np.float32)
    t = rng.uniform(0.05, 1.0, size=(batch,)).astype(np.float32)
    return x, y, t


class Replay:
    """Noise source that hands out recorded draws in order."""

    def __init__(self, draws):
        self.draws = [np.array(d) for d in draws]

    def __call__(self, shape):
        z = self.draws.pop(0)
        assert z.shape == tuple(shape)
        return torch.from_numpy(z)


def jax_sampler_draws(key, p_steps, shape, use_path, y_shape=None):
    """The JAX conditional sampler's draws (`sampling/pc.py:165` and the
    branches after it, `sampling/correctors.py:37-39`), in the port's order
    of use; ``y_shape`` is y's where it differs from x's ``shape``."""
    normal = lambda k: jax.random.normal(k, shape)  # noqa: E731
    normal_y = lambda k: jax.random.normal(k, y_shape or shape)  # noqa: E731
    rng, prior = jax.random.split(key)
    draws = [normal(prior)]
    if use_path:
        rng, ry = jax.random.split(rng)
        draws.append(normal_y(ry))
        for _ in range(p_steps):
            rng, rk, rp, rc = jax.random.split(rng, 4)
            draws += [normal_y(rk), normal(rp), normal(jax.random.fold_in(rc, 0))]
    else:
        for _ in range(p_steps):
            rng, ryc, rc, ryp, rp = jax.random.split(rng, 5)
            draws += [normal_y(ryc), normal(jax.random.fold_in(rc, 0)), normal_y(ryp), normal(rp)]
    return draws


def train_toy_configs(warmup: int = 0, dropout: float = 0.0, batch: int = 2, grad_clip: float = 1.0):
    """The JAX and port toy recipes for training: batch ``batch``, dropout
    ``dropout``, ``warmup`` warmup steps, the recipe's Adam and clip."""
    configs = []
    for config in (jax_toy_config(fused_tail=False), torch_toy_config(fused_tail=False)):
        config.model.dropout = dropout
        config.training.batch_size = batch
        config.optim.warmup = warmup
        config.optim.grad_clip = grad_clip
        configs.append(config)
    return configs


def jax_toy_params(config, seed: int = 1):
    """The JAX toy module and numpy params redrawn by `randomize_params`,
    from shapes alone (no compile)."""
    from conditional_score_diffusion_tpu.models import init_model_shapes_only

    try:
        module, params = init_model_shapes_only(config, jax.random.key(0))
    finally:
        reset_jax_dispatch()
    return module, randomize_params(jax.device_get(params), seed)


def jax_loss_draws(rng, shapes, train: bool = True, eps: float = 1e-5):
    """``t`` and the per-domain noise that the JAX multi-speed loss draws
    from ``rng`` (`losses/continuous.py:58-86`: t; the dropout key in
    train mode; one key per sorted domain), as numpy."""
    rng_t, rng = jax.random.split(rng)
    if train:
        _, rng = jax.random.split(rng)
    B = next(iter(shapes.values()))[0]
    draws = {"t": np.asarray(jax.random.uniform(rng_t, (B,), minval=eps, maxval=1.0))}
    for k in sorted(shapes):
        rng_z, rng = jax.random.split(rng)
        draws[k] = np.asarray(jax.random.normal(rng_z, shapes[k]))
    return draws


def jax_step_draws(key, step: int, shapes):
    """The draws of the JAX train step ``step`` (`training/steps.py`:
    ``fold_in(rng, state.step)``, no accumulation)."""
    return jax_loss_draws(jax.random.fold_in(key, step), shapes)


def to_torch(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def hold_gradients(got, want, tol: float, noise_level: float = 1e-6):
    """Each gradient tensor of ``got`` against ``want`` (dicts by name) at
    ``tol`` of the tensor's largest magnitude; a tensor whose gradient is
    below ``noise_level`` of the largest of all (zero in exact arithmetic:
    a bias before a one-channel-per-group GroupNorm, an attention key bias)
    is rounding noise on both sides and is held at ``noise_level`` of that
    largest gradient instead."""
    assert got.keys() == want.keys()
    top = max(g.abs().max().item() for g in want.values())
    for name, g in want.items():
        err = (got[name] - g).abs().max().item()
        tmax = g.abs().max().item()
        assert err <= (tol * tmax if tmax >= noise_level * top else noise_level * top), (name, err, tmax, top)


def ncsnpp_toy_config(base, embedding_type="positional", fir=True, name="ncsnpp"):
    """A 16px unconditional NCSN++ recipe in either framework (``base``: its
    configs.base): nf=16, ch_mult (1, 2), one BigGAN resblock a level,
    attention at 8, no progressive pyramids; dropout 0."""
    c = base.base_config()
    base.image_model_defaults(c.model)
    m, d = c.model, c.data
    m.name, m.nf, m.ch_mult, m.num_res_blocks, m.attn_resolutions = name, 16, (1, 2), 1, (8,)
    m.dropout, m.fir, m.embedding_type = 0.0, fir, embedding_type
    d.image_size = d.effective_image_size = 16
    d.num_channels, d.shape = 3, [3, 16, 16]
    return c


def jax_init_params(config, seed: int = 1):
    """The JAX module and its params (`init_model`), every leaf redrawn by
    `randomize_params` but a Fourier projection's W (it keeps its
    N(0, 16^2) draw)."""
    from conditional_score_diffusion_tpu.models import init_model

    try:
        module, params = init_model(config, jax.random.key(0))
    finally:
        reset_jax_dispatch()
    params = jax.device_get(params)
    out = randomize_params(params, seed)
    tree = params.get("unet", params)
    if "fourier" in tree:
        out.get("unet", out)["fourier"]["W"] = np.asarray(tree["fourier"]["W"])
    return module, out


def jax_unconditional_draws(key, p_steps, shape, predictor, corrector, c_steps=1):
    """The JAX unconditional sampler's draws (`sampling/pc.py:get_pc_sampler`:
    the prior, then each step the corrector's ``fold_in(rc, i)`` for each of
    its steps and the predictor's ``rp``; ``none`` draws nothing)."""
    rng, prior = jax.random.split(key)
    draws = [jax.random.normal(prior, shape)]
    for _ in range(p_steps):
        rng, rc, rp = jax.random.split(rng, 3)
        if corrector.removeprefix("conditional_") != "none":
            draws += [jax.random.normal(jax.random.fold_in(rc, i), shape) for i in range(c_steps)]
        if predictor.removeprefix("conditional_") != "none":
            draws.append(jax.random.normal(rp, shape))
    return draws


def jax_projected_draws(key, steps, shape, predictor, corrector, c_steps=1):
    """The draws of the JAX inpainter and colorizer (`sampling/pc.py:
    get_pc_inpainter`, `sampling/controllable.py:get_pc_colorizer`): the
    prior, then each step the 5-way split's corrector draws ``fold_in(rc,
    i)``, the projection's ``rmc``, the predictor's ``rp`` and the
    projection's ``rmp`` (``none`` draws nothing)."""
    rng, prior = jax.random.split(key)
    draws = [jax.random.normal(prior, shape)]
    for _ in range(steps):
        rng, rc, rmc, rp, rmp = jax.random.split(rng, 5)
        if corrector.removeprefix("conditional_") != "none":
            draws += [jax.random.normal(jax.random.fold_in(rc, i), shape) for i in range(c_steps)]
        draws.append(jax.random.normal(rmc, shape))
        if predictor.removeprefix("conditional_") != "none":
            draws.append(jax.random.normal(rp, shape))
        draws.append(jax.random.normal(rmp, shape))
    return draws


def unconditional_toy_pair(name, sde_name="vesde", seed=7, out_scale=1.0):
    """(JAX config, port config, JAX module and params, port model) of the
    16px unconditional toy ``name`` (`ncsnpp_toy_config`: ``ncsnpp`` with
    FIR, or ``ddpm``) under ``sde_name``, the same weights on both sides,
    the output conv scaled by ``out_scale``."""
    from conditional_score_diffusion_tpu.configs import base as jax_base
    from conditional_score_diffusion_tpu_torch.configs import base as torch_base
    from conditional_score_diffusion_tpu_torch.models import create_model
    from conditional_score_diffusion_tpu_torch.models.convert import flax_to_state_dict

    jconfig, tconfig = ncsnpp_toy_config(jax_base, name=name), ncsnpp_toy_config(torch_base, name=name)
    for c in (jconfig, tconfig):
        c.training.sde = sde_name
        c.model.input_channels = c.model.output_channels = 3  # the DDPM reads them
    module, params = jax_init_params(jconfig, seed=seed)
    params["conv_out"] = {k: v * np.float32(out_scale) for k, v in params["conv_out"].items()}
    model = create_model(tconfig, device="cpu")
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return jconfig, tconfig, module, params, model
