"""The port's NCSN normalizations (`models/normalization.py`) against the
JAX package's (`models/normalization.py`): every class, with and without
its bias, on the same parameters (the Flax init's, carried by
`models/convert.py`) and inputs, at 1e-6 of the output's largest
magnitude; the Flax parameter tree's shapes against the port's; and
`get_normalization`'s dispatch.

`ConditionalInstanceNorm2d` with its bias builds one ``embed`` table of
``(num_classes, 2C)`` in Flax (its two branches each make one ``nn.Embed``
named ``embed``), the gamma chunk first and the beta chunk, less 1, second;
the port is held to what JAX computes with that table.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conditional_score_diffusion_tpu.models import normalization as jnorm
from conditional_score_diffusion_tpu_torch.configs.base import Config
from conditional_score_diffusion_tpu_torch.models import layers as tlayers
from conditional_score_diffusion_tpu_torch.models import normalization as tnorm
from conditional_score_diffusion_tpu_torch.models.convert import flax_to_state_dict, state_dict_to_flax

torch.set_num_threads(1)

TOL = 1e-6
C, CLASSES = 6, 10

# (name, conditional, bias values to try)
CLASSES_UNDER_TEST = [
    ("InstanceNorm2d", False, [None]),
    ("InstanceNorm2dPlus", False, [True, False]),
    ("VarianceNorm2d", False, [None]),
    ("NoneNorm2d", False, [None]),
    ("ConditionalInstanceNorm2dPlus", True, [True, False]),
    ("ConditionalInstanceNorm2d", True, [True, False]),
    ("ConditionalVarianceNorm2d", True, [None]),
    ("ConditionalNoneNorm2d", True, [True, False]),
    ("ConditionalBatchNorm2d", True, [True, False]),
]
CASES = [(name, cond, bias) for name, cond, biases in CLASSES_UNDER_TEST for bias in biases]


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((3, 5, 7, C)) * 2.0 + rng.standard_normal(C)).astype(np.float32)
    y = np.array([0, 7, 3], np.int32)
    return x, y


def _pair(name, cond, bias):
    kw = {} if bias is None else {"bias": bias}
    if cond:
        return getattr(jnorm, name)(C, CLASSES, **kw), getattr(tnorm, name)(C, CLASSES, **kw)
    return getattr(jnorm, name)(C, **kw), getattr(tnorm, name)(C, **kw)


@pytest.mark.parametrize("name,cond,bias", CASES)
def test_norm_matches_jax(name, cond, bias):
    x, y = _inputs()
    jmod, tmod = _pair(name, cond, bias)
    args = (jnp.asarray(x), jnp.asarray(y)) if cond else (jnp.asarray(x),)
    variables = jmod.init(jax.random.key(1), *args)
    params = jax.device_get(variables.get("params", {}))
    # the Flax tree and the port's parameters are the same set, shape for shape
    want_shapes = {k: tuple(v.shape) for k, v in flax_to_state_dict(params).items()}
    assert want_shapes == {k: tuple(v.shape) for k, v in tmod.state_dict().items()}
    tmod.load_state_dict(flax_to_state_dict(params), strict=True)
    want = np.asarray(jmod.apply(variables, *args))
    targs = (torch.from_numpy(x), torch.from_numpy(y)) if cond else (torch.from_numpy(x),)
    with torch.no_grad():
        got = tmod(*targs).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * np.abs(want).max(), np.abs(got - want).max()


def test_conditional_instance_norm_with_bias_has_one_table():
    """JAX `ConditionalInstanceNorm2d(bias=True)`: one ``embed`` table of
    (classes, 2C); its second chunk, less 1, is the bias."""
    x, y = _inputs()
    jmod = jnorm.ConditionalInstanceNorm2d(4, CLASSES)
    params = jmod.init(jax.random.key(0), jnp.asarray(x[..., :4]), jnp.asarray(y))["params"]
    assert {k: v.shape for k, v in params["embed"].items()} == {"embedding": (CLASSES, 8)}
    table = np.zeros((CLASSES, 8), np.float32)
    table[:, :4], table[:, 4:] = 2.0, 1.5  # gamma 2, beta 0.5
    got = np.asarray(jmod.apply({"params": {"embed": {"embedding": table}}}, jnp.asarray(x[..., :4]), jnp.asarray(y)))
    xn = (x[..., :4] - x[..., :4].mean((1, 2), keepdims=True)) / np.sqrt(x[..., :4].var((1, 2), keepdims=True) + 1e-5)
    np.testing.assert_allclose(got, 2.0 * xn + 0.5, atol=1e-5)
    tmod = tnorm.ConditionalInstanceNorm2d(4, CLASSES)
    tmod.load_state_dict({"embed.embedding": torch.from_numpy(table)})
    with torch.no_grad():
        np.testing.assert_allclose(tmod(torch.from_numpy(x[..., :4]), torch.from_numpy(y)).numpy(), got, atol=1e-6)


def test_instance_norm_plus_uses_the_unbiased_channel_variance():
    """The channel means are standardized with ddof=1 (torch.var's
    default in the reference), the spatial variance with ddof=0."""
    x, _ = _inputs()
    mod = tnorm.InstanceNorm2dPlus(C, bias=False)
    with torch.no_grad():
        mod.alpha.fill_(1.0)
        mod.gamma.fill_(1.0)
        got = mod(torch.from_numpy(x)).numpy()
    means = x.mean((1, 2))
    m = (means - means.mean(-1, keepdims=True)) / np.sqrt(means.var(-1, ddof=1, keepdims=True) + 1e-5)
    xn = (x - x.mean((1, 2), keepdims=True)) / np.sqrt(x.var((1, 2), keepdims=True) + 1e-5)
    np.testing.assert_allclose(got, xn + m[:, None, None, :], atol=1e-5)


def test_default_init_is_the_flax_form():
    """Scales and tables around 1 (N(1, 0.02)), biases 0."""
    torch.manual_seed(0)
    mod = tnorm.ConditionalInstanceNorm2dPlus(64, 100)
    plus = tnorm.InstanceNorm2dPlus(64)
    for t in (mod.embed.embedding, plus.alpha, plus.gamma):
        assert abs(t.mean().item() - 1.0) < 0.01 and 0.01 < t.std().item() < 0.03
    assert torch.equal(plus.beta, torch.zeros(64))


def test_converter_round_trip_of_the_norm_leaves():
    mod = tnorm.ConditionalInstanceNorm2dPlus(C, CLASSES)
    plus = tnorm.InstanceNorm2dPlus(C)
    sd = {**{f"a.{k}": v for k, v in mod.state_dict().items()}, **{f"b.{k}": v for k, v in plus.state_dict().items()}}
    tree = state_dict_to_flax(sd)
    assert set(tree["a"]["embed"]) == {"embedding"} and set(tree["b"]) == {"alpha", "gamma", "beta"}
    back = flax_to_state_dict(tree)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)


@pytest.mark.parametrize("norm,want", [
    ("InstanceNorm", "InstanceNorm2d"), ("InstanceNorm++", "InstanceNorm2dPlus"), ("VarianceNorm", "VarianceNorm2d"),
])
def test_get_normalization_matches_jax(norm, want):
    config = Config(model=Config(normalization=norm, num_classes=CLASSES))
    assert jnorm.get_normalization(config).__name__ == want
    assert tnorm.get_normalization(config) is getattr(tnorm, want)


def test_get_normalization_conditional_and_group_norm():
    config = Config(model=Config(normalization="InstanceNorm++", num_classes=CLASSES))
    j, t = jnorm.get_normalization(config, conditional=True), tnorm.get_normalization(config, conditional=True)
    assert j.func is jnorm.ConditionalInstanceNorm2dPlus and j.keywords == {"num_classes": CLASSES}
    assert t.func is tnorm.ConditionalInstanceNorm2dPlus and t.keywords == {"num_classes": CLASSES}
    for fn in (jnorm.get_normalization, tnorm.get_normalization):
        with pytest.raises(NotImplementedError):
            fn(Config(model=Config(normalization="InstanceNorm", num_classes=CLASSES)), conditional=True)
        with pytest.raises(ValueError):
            fn(Config(model=Config(normalization="BatchNorm")))
    gn = tnorm.get_normalization(Config(model=Config(normalization="GroupNorm")))
    assert gn is tlayers.legacy_group_norm and gn(64).num_groups == 32
