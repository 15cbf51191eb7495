"""The port's NCSN / NCSNv2 family (`models/ncsnv2.py`) against the JAX
package's (`models/ncsnv2.py`) on the same weights (`models/convert.py`).

* The four registered models (``ncsn``, ``ncsnv2_64``, ``ncsnv2_128`` at
  32px, ``ncsnv2_256`` at 64px; nf 16) built from the JAX recipes
  (`configs/ncsn_legacy.py`) shrunk to toy size: same-weights forwards at
  5e-4 of the output's largest magnitude, as the other families are held;
  ``ncsn`` on integer labels and on the float sigma labels JAX's discrete
  VE score feeds it.
* The converter's round trip, exactly.
* The layers one by one at 1e-6: the 5x5 pools at the borders, the
  align-corners bilinear resize (a dense matrix in JAX, `F.interpolate`
  here), `ConvMeanPool` with ``adjust_padding``, `MeanPoolConv`,
  `UpsampleConv`, and a dilated down-sampling block, which keeps its size.
* The float-sigma class hazard (ROADMAP.md section 3): NCSN casts its
  label to an integer, so under the discrete VE score its class is
  floor(sigma), not the level index, in both packages.

Weights: conv kernels and biases N(0, 0.05), the norms' scales and class
tables 1 + N(0, 0.1) (numpy, seeded), so no norm scales its output to ~0.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conditional_score_diffusion_tpu.configs import ncsn_legacy as jax_legacy
from conditional_score_diffusion_tpu.models import init_model_shapes_only
from conditional_score_diffusion_tpu.models import ncsnv2 as jnc
from conditional_score_diffusion_tpu.sde import VESDE as JaxVESDE
from conditional_score_diffusion_tpu_torch.configs.base import Config
from conditional_score_diffusion_tpu_torch.models import create_model, init_model_random
from conditional_score_diffusion_tpu_torch.models import ncsnv2 as tnc
from conditional_score_diffusion_tpu_torch.models.convert import flax_to_state_dict, state_dict_to_flax
from conditional_score_diffusion_tpu_torch.sde import VESDE

torch.set_num_threads(2)

FORWARD_TOL, LAYER_TOL = 5e-4, 1e-6
MODELS = [("ncsn", 32), ("ncsnv2_64", 32), ("ncsnv2_128", 32), ("ncsnv2_256", 64)]
SIGMA_LABELS = np.array([3.7, 40.2], np.float32)  # what the discrete VE score feeds an unconditional model


def port_config(jax_config):
    def conv(v):
        return Config(**{k: conv(x) for k, x in v.items()}) if isinstance(v, dict) else v

    return conv(jax_config.to_dict())


def jax_config(name, size, nf=16):
    config = jax_legacy.ncsn_config("cifar10", "124") if name == "ncsn" else jax_legacy.ncsnv2_config("cifar10")
    config.model.name, config.model.nf = name, nf
    config.data.image_size = config.data.effective_image_size = size
    config.data.shape = [3, size, size]
    return config


def ncsn_params(params, seed=1):
    """Every leaf redrawn: scales and tables around 1, the rest N(0, 0.05)."""
    rng = np.random.RandomState(seed)

    def walk(tree):
        out = {}
        for k in sorted(tree):
            v = tree[k]
            if hasattr(v, "items"):
                out[k] = walk(dict(v))
            elif k in ("alpha", "gamma", "embedding", "scale"):
                out[k] = (1.0 + 0.1 * rng.randn(*np.shape(v))).astype(np.float32)
            else:
                out[k] = (0.05 * rng.randn(*np.shape(v))).astype(np.float32)
        return out

    return walk(dict(params))


@functools.lru_cache(maxsize=None)
def pair(name, size):
    jconfig = jax_config(name, size)
    module, params = init_model_shapes_only(jconfig, jax.random.key(0))
    params = ncsn_params(jax.device_get(params))
    model = create_model(port_config(jconfig), device="cpu")
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    apply = jax.jit(lambda p, x, c: module.apply({"params": p}, x, c, train=False))
    return module, params, model, apply


def inputs(size, seed=0):
    return np.random.default_rng(seed).uniform(size=(2, size, size, 3)).astype(np.float32)


def rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("name,size", MODELS)
def test_forward_matches_jax(name, size):
    _, params, model, apply = pair(name, size)
    x = inputs(size)
    labels = [SIGMA_LABELS, np.floor(SIGMA_LABELS).astype(np.int32)] if name == "ncsn" else [SIGMA_LABELS]
    for cond in labels:
        want = np.asarray(apply(params, jnp.asarray(x), jnp.asarray(cond)))
        with torch.no_grad():
            got = model(torch.from_numpy(x), torch.from_numpy(cond)).numpy()
        assert got.shape == want.shape == x.shape
        assert rel(got, want) <= FORWARD_TOL, (name, cond, rel(got, want))


def test_ncsn_class_is_the_floor_of_a_float_label():
    """``cond.astype(int32)``: sigma 3.7 and 40.2 select classes 3 and 40
    in both packages, and another label of the same floor gives the same
    output."""
    _, params, model, apply = pair("ncsn", 32)
    x = torch.from_numpy(inputs(32))
    with torch.no_grad():
        a = model(x, torch.from_numpy(SIGMA_LABELS))
        b = model(x, torch.tensor([3.0, 40.0]))
        c = model(x, torch.tensor([4.0, 40.0]))
    assert torch.equal(a, b) and not torch.equal(a, c)
    ja = apply(params, jnp.asarray(x.numpy()), jnp.asarray(SIGMA_LABELS))
    jb = apply(params, jnp.asarray(x.numpy()), jnp.asarray([3.0, 40.0], jnp.float32))
    assert np.array_equal(np.asarray(ja), np.asarray(jb))


@pytest.mark.parametrize("variant", ["v1", "124"])
def test_ncsn_classes_under_the_discrete_ve_score(variant):
    """The classes an unconditional NCSN sees under JAX's discrete VE score
    (`models/wrappers.py`: the sigma at the rounded level) are
    floor(sigma): classes 0 and 1 for the v1 recipes (sigma_max 1, 10
    levels), 44 classes between 0 and 50 for cifar10_124 (sigma_max 50,
    232 levels; the ladder's top steps skip some integers); the port's
    ladder gives the same."""
    m = jax_legacy.ncsn_config("cifar10", variant).model
    jsde = JaxVESDE(sigma_min=m.sigma_min, sigma_max=m.sigma_max, N=m.num_scales)
    want = set(np.asarray(jsde.discrete_sigmas.astype(jnp.int32)).tolist())
    got = set(VESDE(m.sigma_min, m.sigma_max, N=m.num_scales).discrete_sigmas("cpu").to(torch.int32).tolist())
    assert want == got
    if variant == "v1":
        assert got == {0, 1}
    else:
        assert got <= set(range(51)) and {0, 1, 2, 50} <= got and len(got) == 44


@pytest.mark.parametrize("name,size", MODELS)
def test_converter_round_trip_is_exact(name, size):
    _, params, model, _ = pair(name, size)
    tree = state_dict_to_flax(model.state_dict())

    def leaves(t, prefix=()):
        for k, v in t.items():
            yield from leaves(v, prefix + (k,)) if hasattr(v, "items") else [(prefix + (k,), np.asarray(v))]

    want, got = dict(leaves(params)), dict(leaves(tree))
    assert want.keys() == got.keys()
    assert all(np.array_equal(want[k], got[k]) for k in want)
    back = flax_to_state_dict(tree)
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())


@pytest.mark.parametrize("name", ["ncsn", "ncsnv2_64", "ncsnv2_128", "ncsnv2_256"])
def test_registry_builds_from_the_recipes(name):
    """`create_model` takes JAX `from_config`'s fields; `init_model_random`
    draws the norms' scales and tables around 1."""
    config = port_config(jax_config(name, 64, nf=8))
    model = create_model(config, device="meta")
    assert type(model).__name__ == {"ncsn": "NCSN", "ncsnv2_64": "NCSNv2", "ncsnv2_128": "NCSNv2_128",
                                    "ncsnv2_256": "NCSNv2_256"}[name]
    assert (model.nf, model.num_scales, model.nonlinearity, model.centered) == (8, config.model.num_scales, "elu", False)
    rand = init_model_random(port_config(jax_config(name, 32, nf=8)), seed=3, device="cpu")
    scales = [p for n, p in rand.named_parameters() if n.rsplit(".", 1)[-1] in ("alpha", "gamma", "embedding")]
    assert scales and all(abs(p.mean().item() - 1.0) < 0.05 for p in scales)


# ---- the layers -------------------------------------------------------------


def _layer_inputs(shape, seed=2):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("kind", ["max", "avg"])
def test_pool5_matches_jax(kind):
    x = _layer_inputs((2, 7, 6, 3))
    want = np.asarray(jnc._pool5(jnp.asarray(x), kind))
    got = tnc.pool5(torch.from_numpy(x), kind).numpy()
    assert np.abs(got - want).max() <= LAYER_TOL * np.abs(want).max()
    if kind == "avg":  # the corner divides by 25 although 9 inputs fall inside
        np.testing.assert_allclose(got[:, 0, 0], x[:, :3, :3].sum((1, 2)) / 25.0, rtol=1e-6)


@pytest.mark.parametrize("src,dst", [((8, 8), (16, 16)), ((5, 7), (9, 13)), ((4, 4), (4, 4)), ((3, 5), (1, 1))])
def test_bilinear_align_corners_matches_jax(src, dst):
    x = _layer_inputs((2, *src, 4))
    want = np.asarray(jnc.bilinear_resize_align_corners(jnp.asarray(x), dst))
    got = tnc.bilinear_resize_align_corners(torch.from_numpy(x), dst).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= LAYER_TOL * np.abs(want).max()


def _layer_pair(jmod, tmod, x):
    params = jax.device_get(jmod.init(jax.random.key(0), jnp.asarray(x))["params"])
    params = ncsn_params(params)
    tmod.load_state_dict(flax_to_state_dict(params), strict=True)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= LAYER_TOL * np.abs(want).max()
    return got


@pytest.mark.parametrize("kernel", [3, 1])
def test_conv_mean_pool_with_adjust_padding_matches_jax(kernel):
    """A 27px input padded at the top left to 28, then pooled to 14."""
    x = _layer_inputs((2, 27, 27, 4))
    got = _layer_pair(jnc.ConvMeanPool(5, kernel, adjust_padding=True), tnc.ConvMeanPool(4, 5, kernel, adjust_padding=True), x)
    assert got.shape == (2, 14, 14, 5)


def test_mean_pool_conv_and_upsample_conv_match_jax():
    x = _layer_inputs((2, 8, 6, 4))
    assert _layer_pair(jnc.MeanPoolConv(5), tnc.MeanPoolConv(4, 5), x).shape == (2, 4, 3, 5)
    assert _layer_pair(jnc.UpsampleConv(5), tnc.UpsampleConv(4, 5), x).shape == (2, 16, 12, 5)


@pytest.mark.parametrize("dilation", [1, 2])
def test_down_block_matches_jax(dilation):
    """A dilated down block keeps the size, its shortcut a dilated 3x3
    conv; an undilated one pools through `ConvMeanPool`."""
    x = _layer_inputs((2, 8, 8, 4))
    norm = jnc.get_normalization(type("c", (), {"model": type("m", (), {"normalization": "InstanceNorm++"})}))
    jmod = jnc.ResidualBlock(6, norm, jax.nn.elu, resample="down", dilation=dilation)
    tmod = tnc.ResidualBlock(4, 6, tnc.get_normalization(Config(model=Config(normalization="InstanceNorm++"))),
                             tnc.ACTS["elu"], resample="down", dilation=dilation)
    got = _layer_pair(jmod, tmod, x)
    assert got.shape == ((2, 8, 8, 6) if dilation > 1 else (2, 4, 4, 6))
    shortcut = tmod.shortcut if dilation > 1 else tmod.shortcut.conv
    assert shortcut.weight.shape[-1] == (3 if dilation > 1 else 1)
