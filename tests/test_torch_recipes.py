"""The port's recipes of the paper's five estimators, the unconditional and
VP recipes and their texture variants, field by field against the JAX
package's recipe functions (ml_collections there, `Config` namespaces here)."""

import math

import pytest
import torch

from conditional_score_diffusion_tpu.configs import celeba_sr as jax_celeba
from conditional_score_diffusion_tpu.configs import extra as jax_extra
from conditional_score_diffusion_tpu_torch import configs
from conditional_score_diffusion_tpu_torch.configs import celeba_sr, extra
from conditional_score_diffusion_tpu_torch.main import load_config

torch.set_num_threads(1)

APPROACHES = ["ours_NDV", "ours_DV", "ours_slowDV", "song", "sr3"]
SECTIONS = ("training", "sampling", "eval", "validation", "data", "model", "optim")


def _plain(value):
    return list(value) if isinstance(value, (list, tuple)) else value


def as_dict(config):
    """Every field of a recipe of either framework, as {section: {key: value}}."""
    if hasattr(config, "to_dict"):
        tree = config.to_dict()
    else:
        tree = {k: (vars(v) if k in SECTIONS else v) for k, v in vars(config).items()}
    return {k: ({f: _plain(x) for f, x in v.items()} if k in SECTIONS else _plain(v)) for k, v in tree.items()}


def assert_same(jax_config, port_config, extra_fields=None):
    """The two recipes hold the same fields with the same values; the port's
    ``extra_fields`` ({section: {key: value}}) aside."""
    want, got = as_dict(jax_config), as_dict(port_config)
    for section, fields in (extra_fields or {}).items():
        for key, value in fields.items():
            assert got[section].pop(key) == value, (section, key)
    assert sorted(got) == sorted(want)
    for section in want:
        if section in SECTIONS:
            assert sorted(got[section]) == sorted(want[section]), section
            for key, value in want[section].items():
                assert got[section][key] == value, (section, key, got[section][key], value)
        else:
            assert got[section] == want[section], section


RECIPES = ["celeba_sr_160_config", "celeba_sr_128_config", "celeba_sr_interpolation_config", "celeba_sr_deep_config"]


@pytest.mark.parametrize("recipe", RECIPES)
@pytest.mark.parametrize("approach", APPROACHES)
def test_celeba_recipes_match_jax(recipe, approach):
    assert_same(getattr(jax_celeba, recipe)(approach), getattr(celeba_sr, recipe)(approach))


@pytest.mark.parametrize("approach", ["ours_NDV", "ours_DV", "sr3"])
def test_celeba_recipe_arguments_match_jax(approach):
    assert_same(jax_celeba.celeba_sr_128_config(approach, smaxy=0.3), celeba_sr.celeba_sr_128_config(approach, smaxy=0.3))
    assert_same(
        jax_celeba.celeba_sr_interpolation_config(approach, smaxy_log10=0.5),
        celeba_sr.celeba_sr_interpolation_config(approach, smaxy_log10=0.5),
    )


def test_estimator_fields():
    """What sets each estimator apart, as the paper's table has it."""
    c = {a: celeba_sr.celeba_sr_160_config(a) for a in APPROACHES}
    root = math.sqrt(3 * 160 * 160)
    assert c["song"].training.conditioning_approach == "Song" and c["song"].model.sigma_max_y == root
    assert c["ours_DV"].training.lightning_module == c["ours_slowDV"].training.lightning_module == (
        "conditional_decreasing_variance")
    assert (c["ours_DV"].model.sigma_max_y_target, c["ours_DV"].model.reach_target_steps) == (0.5, 250000)
    assert (c["ours_slowDV"].model.sigma_max_y_target, c["ours_slowDV"].model.reach_target_steps) == (1.0, 500000)
    # CDE carries the anneal's fields, but its task anneals nothing
    assert c["sr3"].training.lightning_module == "conditional" and c["sr3"].model.reach_target_steps == 250000
    assert (c["sr3"].model.name, c["sr3"].model.output_channels) == ("ddpm_paired_SR3", 3)
    with pytest.raises(ValueError, match="unknown"):
        celeba_sr.celeba_sr_160_config("cdiffe")


def test_texture64_dv_recipe_matches_jax():
    from configs.artifacts.texture64_sr_dv import get_config

    assert_same(get_config(), configs.texture64_sr_dv_config())


TEXTURE160 = {
    "texture160_sr_vscmde": "ours_DV",
    "texture160_sr_vscmde_slow": "ours_slowDV",
    "texture160_sr_cdiffe": "song",
    "texture160_sr_cde": "sr3",
    "texture160_sr_cmde": "ours_NDV",
}


@pytest.mark.parametrize("name", sorted(TEXTURE160))
def test_texture160_recipes_are_the_flagship_on_texture160(name):
    """Each texture160 recipe (by its CLI name) is JAX's
    `celeba_sr_160_config(approach)` with the fields of the JAX texture160
    artifact recipe (`configs/artifacts/texture160_sr_cmde.py`) changed,
    the anneal cut in proportion to the run, and the fused tail on."""
    from configs.artifacts.texture160_sr_cmde import get_config as jax_texture160

    approach = TEXTURE160[name]
    want = jax_celeba.celeba_sr_160_config(approach)
    artifact, flagship = jax_texture160(), jax_celeba.celeba_sr_160_config("ours_NDV")
    for section in ("training", "data", "eval"):
        for key, value in getattr(artifact, section).items():
            if getattr(flagship, section).get(key) != value:
                getattr(want, section)[key] = value
    if "reach_target_steps" in want.model:
        want.model.reach_target_steps = want.model.reach_target_steps * 60000 // 500000
    assert_same(want, load_config(name), {"model": {"fused_tail": True}})


@pytest.mark.parametrize("size", [64, 128])
def test_unconditional_recipe_matches_jax(size):
    assert_same(jax_extra.unconditional_pkl_config(size), extra.unconditional_pkl_config(size))


def test_texture160_unconditional_recipe():
    want = jax_extra.unconditional_pkl_config(128)
    want.data.dataset, want.data.base_dir = "texture160", "datasets"
    assert_same(want, load_config("texture160_unconditional_ncsnpp"))


@pytest.mark.parametrize("sde", ["vpsde", "subvpsde"])
def test_vp_recipe_matches_jax(sde):
    assert_same(jax_extra.cifar10_vp_config(sde), extra.cifar10_vp_config(sde))
    assert_same(jax_extra.cifar10_vp_config(sde, "ddpm"), extra.cifar10_vp_config(sde, "ddpm"))
