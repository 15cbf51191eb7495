"""The port's inverse-problem recipes against the JAX package's.

* Every recipe file under ``configs/ve/inverse_problems/{inpainting,
  colorization, image_to_image_translation, MRI_to_PET}`` (41, master
  configs included), loaded by path in JAX and through the port's
  `configs.inverse_problems.RECIPES` (by key and by the same path through
  `main.load_config`): field by field, as `tests/test_torch_recipes.py`
  compares them.
* The recipe functions with every argument, and `mri_to_pet_config` for each
  estimator, 2-D and 3-D.
* The texture twins: the JAX recipe with only the data, the test range,
  the ``consistency`` metric and the kernel knobs changed.
* The ``_block`` twins' kernel calls per forward at full width (128px,
  64px, 96px; B=8) on the meta device, against the sites `chip_smoke.py`
  checks and counts.
"""

import glob
import importlib.util
import os

import jax  # noqa: F401  (the parity files import both frameworks)
import pytest
import torch

from test_torch_recipes import assert_same
from conditional_score_diffusion_tpu.configs import extra as jax_extra
from conditional_score_diffusion_tpu.configs import inverse_problems as jax_inverse
from conditional_score_diffusion_tpu_torch.configs import extra, inverse_problems
from conditional_score_diffusion_tpu_torch.main import load_config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREES = ("inpainting", "colorization", "image_to_image_translation", "MRI_to_PET")


def jax_recipe(key):
    path = os.path.join(REPO, "configs", key + ".py")
    spec = importlib.util.spec_from_file_location("jax_recipe", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.get_config()


def assert_same_recipe(want, got):
    """A leaf recipe, or each sub-recipe of a master config."""
    if "training" in want:
        assert_same(want, got)
        return
    assert sorted(want.keys()) == sorted(vars(got))
    for name in want.keys():
        assert_same(want[name], getattr(got, name))


def test_the_table_covers_the_jax_tree():
    files = [
        os.path.relpath(p, os.path.join(REPO, "configs"))[: -len(".py")]
        for tree in TREES
        for p in glob.glob(os.path.join(REPO, "configs", "ve", "inverse_problems", tree, "**", "*.py"), recursive=True)
    ]
    assert len(files) == 41
    assert sorted(inverse_problems.RECIPES) == sorted(files)


@pytest.mark.parametrize("key", sorted(inverse_problems.RECIPES))
def test_recipe_matches_the_jax_file(key):
    want = jax_recipe(key)
    assert_same_recipe(want, inverse_problems.RECIPES[key]())
    assert_same_recipe(want, load_config(os.path.join("configs", key + ".py")))
    assert_same_recipe(want, load_config(key))


@pytest.mark.parametrize("task", ["inpainting", "colorization", "image-to-image"])
@pytest.mark.parametrize("approach", list(inverse_problems.APPROACHES))
def test_inverse_problem_config_matches_jax(task, approach):
    assert_same(jax_inverse.inverse_problem_config(task, approach), inverse_problems.inverse_problem_config(task, approach))


def test_estimator_fields():
    """sigma_max_y by estimator, the image-to-image VS-CMDE's 300k anneal,
    CDE's 3 output channels."""
    c = {(t, a): inverse_problems.inverse_problem_config(t, a) for t in ("inpainting", "colorization", "image-to-image")
         for a in inverse_problems.APPROACHES}
    assert [c[(t, "ours_NDV")].model.sigma_max_y for t in ("inpainting", "colorization", "image-to-image")] == [1.0, 0.1, 1.0]
    assert c[("colorization", "song")].model.sigma_max_y == c[("colorization", "song")].model.sigma_max_x
    assert c[("image-to-image", "ours_DV")].model.reach_target_steps == 300000
    assert c[("inpainting", "ours_DV")].model.reach_target_steps == 500000
    assert c[("colorization", "ours_DV")].model.reach_target_steps == 250000
    assert [c[(t, "sr3")].model.output_channels for t in ("inpainting", "colorization")] == [3, 3]
    assert c[("colorization", "ours_NDV")].model.output_channels == 4


@pytest.mark.parametrize("volumetric", [False, True])
@pytest.mark.parametrize("approach", ["ours_DV", "ours_NDV", "sr3"])
def test_mri_to_pet_config_matches_jax(volumetric, approach):
    assert_same(jax_extra.mri_to_pet_config(volumetric, approach), extra.mri_to_pet_config(volumetric, approach))


def test_sweeps_match_jax():
    for k in range(1, 10):
        assert_same(jax_inverse.i2i_interpolation_config(k), inverse_problems.i2i_interpolation_config(k))
    assert_same(jax_inverse.i2i_interpolation_config(sr3=True), inverse_problems.i2i_interpolation_config(sr3=True))
    for k in range(1, 11):
        assert_same(jax_inverse.inpainting_interpolation_config(k), inverse_problems.inpainting_interpolation_config(k))
    assert inverse_problems.INPAINTING_SWEEP == jax_inverse.INPAINTING_SWEEP


def _twin_of(jax_config, dataset, base_dir, block, consistency=True):
    jax_config.data.dataset, jax_config.data.base_dir = dataset, base_dir
    jax_config.eval.first_test_batch, jax_config.eval.last_test_batch = 0, 1
    if consistency:
        jax_config.eval.evaluation_metrics = list(jax_config.eval.evaluation_metrics) + ["consistency"]
    if block:
        jax_config.model.fused_tail = jax_config.model.fused_block = True
    return jax_config


def test_twins_are_the_jax_recipes_on_texture_data():
    ip, base = inverse_problems, "some/dir"
    cases = [
        (_twin_of(jax_inverse.inverse_problem_config("inpainting", "ours_NDV"), "texture160", "datasets", False),
         load_config("texture160_inpainting_cmde")),
        (_twin_of(jax_inverse.inverse_problem_config("inpainting", "ours_NDV"), "texture160", "datasets", True),
         load_config("texture160_inpainting_cmde_block")),
        (_twin_of(jax_inverse.inverse_problem_config("colorization", "ours_NDV"), "texture160", "datasets", True),
         load_config("texture160_colorization_cmde_block")),
        (_twin_of(jax_inverse.inverse_problem_config("image-to-image", "ours_NDV"), ip.I2I_DATASET, base, True),
         ip.texture64_i2i_cmde_block_config(base)),
        (_twin_of(jax_extra.mri_to_pet_config(False), ip.MRI_DATASET, base, True, consistency=False),
         ip.texture_mri_to_pet_slices_block_config(base)),
        (_twin_of(jax_extra.mri_to_pet_config(True), ip.MRI3D_DATASET, base, False, consistency=False),
         ip.texture_mri_to_pet_3d_config(base)),
    ]
    for want, got in cases:
        assert_same(want, got)
    assert load_config("texture64_i2i_cmde_block").data.base_dir == ip.TWIN_DIR


def test_block_twins_kernel_sites_match_chip_smoke():
    """One forward of each ``_block`` twin's model at full width, B=8, on
    the meta device: kernels 1-3 called at exactly the sites and counts
    `chip_smoke.py` checks the kernels at and gates the launches on; the
    3-D twin calls none."""
    import chip_smoke

    seen = set()
    for label, recipe, _, want in chip_smoke.INVERSE_TWINS:
        config = recipe()
        calls = chip_smoke.forward_calls(config, chip_smoke.BATCH, chip_smoke.twin_inputs(config, "meta"))
        assert dict(calls) == want, label
        seen |= set(calls)
    # the sites the kernel phase checks: all but the image-to-image blocks,
    # which the Haar DDPM's phase checks at the same shapes (3x3 included)
    new = seen - chip_smoke.earlier_sites()
    assert new == seen - set(chip_smoke.SITES_I2I) | {("gn_silu_conv3x3", 16, 256)} and len(new) == 15
    assert {k for k in chip_smoke.SITES_MRI if k[1] == 3} <= new
    config = inverse_problems.texture_mri_to_pet_3d_config()
    config.model.fused_tail = config.model.fused_block = True
    assert not chip_smoke.forward_calls(config, 2, chip_smoke.twin_inputs(config, "meta", 2))
