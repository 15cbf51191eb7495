"""The port's score_sde recipes (`configs/song.py`, `configs/ncsn_legacy.py`,
the path table `configs/score_sde.py`) and the ``image`` datamodule
(`data/image_folder.py`) against the JAX package's.

* Every recipe file of `configs/ve/`, `configs/vp/` and `configs/subvp/`
  that builds on those recipe functions or on one the port has (52
  files; `configs/ve/inverse_problems/` has its own table) loads through
  the table by its path, by key and through `main.load_config`, and equals the JAX file's `get_config()` field by
  field (`test_torch_recipes.assert_same`); the table covers the tree but
  the files left out (Haar flow, SRFlow).
* The recipe functions with each argument.
* The texture twins: the JAX recipe with only its data changed; the
  folder writer on a synthetic source.
* The ``image`` datamodule on synthetic PNG folders: the seeded split, the
  shuffled train batches, val and test in order, the bicubic resize to
  ``shape[1]`` and celebA's centre-crop branch, bit for bit against JAX's.
* The CLI: ``--mode train --config configs/ve/ncsnv2/celeba.py`` on the
  CPU, the table entry wrapped to toy size as `chip_smoke.py` wraps it
  (there, only n_iters); the NCSN++ twin's FIR calls per forward against
  `chip_smoke.py`'s constant.
"""

import glob
import importlib.util
import os
import pickle

import jax  # noqa: F401  (the parity files import both frameworks)
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_recipes import assert_same
from conditional_score_diffusion_tpu.configs import ncsn_legacy as jax_legacy
from conditional_score_diffusion_tpu.configs import song as jax_song
from conditional_score_diffusion_tpu.data import image_folder as jax_image_folder
from conditional_score_diffusion_tpu_torch import configs
from conditional_score_diffusion_tpu_torch import main as cli
from conditional_score_diffusion_tpu_torch.configs import ncsn_legacy, score_sde, song
from conditional_score_diffusion_tpu_torch.data import create_datamodule
from conditional_score_diffusion_tpu_torch.data import image_folder
from conditional_score_diffusion_tpu_torch.main import load_config
from conditional_score_diffusion_tpu_torch.training.trainer import read_scalars

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the recipe files the table leaves out, and why (ROADMAP.md section 1)
LEFT_OUT = ("ve/haarflow/", "vp/haarflow/", "ve/srflow/")  # haar_multiscale and the 12b recipes; the SRFlow trees


def jax_recipe(key):
    spec = importlib.util.spec_from_file_location("jax_recipe", os.path.join(REPO, "configs", key + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.get_config()


def test_the_table_covers_the_tree():
    files = []
    for tree in ("ve", "vp", "subvp"):
        for path in glob.glob(os.path.join(REPO, "configs", tree, "**", "*.py"), recursive=True):
            key = os.path.relpath(path, os.path.join(REPO, "configs"))[: -len(".py")]
            if not key.startswith("ve/inverse_problems/") and not key.startswith(LEFT_OUT):
                files.append(key)
    assert len(files) == len(score_sde.RECIPES) == 52
    assert sorted(files) == sorted(score_sde.RECIPES)


@pytest.mark.parametrize("key", sorted(score_sde.RECIPES))
def test_recipe_file_matches_jax(key):
    want = jax_recipe(key)
    assert_same(want, score_sde.RECIPES[key]())
    assert_same(want, load_config(os.path.join("configs", key + ".py")))
    assert_same(want, load_config(key))
    assert score_sde.recipe_key(os.path.join(REPO, "configs", key + ".py")) is None  # keys are relative paths
    assert score_sde.recipe_key(f"configs/{key}.py") == key


@pytest.mark.parametrize("dataset", ["cifar10", "celeba", "lsun"])
def test_default_configs_match_jax(dataset):
    assert_same(jax_song.get_default_configs(dataset), song.get_default_configs(dataset))
    assert song.get_default_configs(dataset).data.datamodule == "image"


@pytest.mark.parametrize("block", ["ncsnpp_block", "ncsnpp_lsun_block", "ddpmpp_block", "ddpm_block"])
def test_model_blocks_match_jax(block):
    for kw in ([{}, {"deep": True}] if block in ("ncsnpp_block", "ddpmpp_block") else [{}]):
        want, got = jax_song.get_default_configs(), song.get_default_configs()
        getattr(jax_song, block)(want.model, **kw)
        getattr(song, block)(got.model, **kw)
        assert_same(want, got)


@pytest.mark.parametrize("dataset", ["FFHQ", "CelebAHQ"])
def test_ffhq_1024_matches_jax(dataset):
    assert_same(jax_song.ffhq_1024_config(dataset), song.ffhq_1024_config(dataset))


@pytest.mark.parametrize("dataset,variant", [(d, v) for d in ("cifar10", "celeba") for v in ("v1", "124", "1245", "5")])
def test_ncsn_config_matches_jax(dataset, variant):
    assert_same(jax_legacy.ncsn_config(dataset, variant), ncsn_legacy.ncsn_config(dataset, variant))


@pytest.mark.parametrize("dataset", ["cifar10", "celeba", "bedroom"])
def test_ncsnv2_config_matches_jax(dataset):
    assert_same(jax_legacy.ncsnv2_config(dataset), ncsn_legacy.ncsnv2_config(dataset))


def test_jan_sweep_matches_jax():
    for arch in ("ddpm", "ncsn", "ncsnv2"):
        assert_same(jax_legacy.jan_celeba64_config(arch), ncsn_legacy.jan_celeba64_config(arch))
    # the sweep's ncsnv2 trains continuously, the other ncsnv2 recipes discretely
    assert ncsn_legacy.jan_celeba64_config("ncsnv2").training.continuous
    assert not ncsn_legacy.ncsnv2_config("celeba").training.continuous
    for fn in (jax_legacy.jan_celeba64_config, ncsn_legacy.jan_celeba64_config):
        with pytest.raises(ValueError):
            fn("ncsnpp")


TWINS = [
    ("texture64_ncsnv2_celeba", "ve/ncsnv2/celeba", score_sde.TEXTURE64_FOLDER),
    ("texture128_ncsnv2_bedroom", "ve/ncsnv2/bedroom", score_sde.TEXTURE128_FOLDER),
    ("texture32_ncsn_cifar10_124", "ve/ncsn/cifar10_124", score_sde.TEXTURE64_FOLDER),
    ("texture32_ncsnpp_cifar10_smld", "ve/cifar10_ncsnpp", score_sde.TEXTURE64_FOLDER),
    ("texture32_ddpm_cifar10_vp", "vp/ddpm/cifar10", score_sde.TEXTURE64_FOLDER),
]


@pytest.mark.parametrize("name,key,folder", TWINS)
def test_twin_is_the_jax_recipe_on_other_data(name, key, folder):
    want = jax_recipe(key)
    want.data.dataset, want.data.base_dir = folder, "some/dir"
    assert_same(want, getattr(configs, f"{name}_config")("some/dir"))
    assert load_config(name).data.base_dir == score_sde.TWIN_DIR


def _write_pklv4(path, images):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(list(images), f)


def test_write_twin_folders(tmp_path):
    rng = np.random.default_rng(0)
    small = rng.integers(0, 256, (5, 64, 64, 3), dtype=np.uint8)
    big = rng.integers(0, 256, (3, 160, 160, 3), dtype=np.uint8)
    _write_pklv4(str(tmp_path / "src" / "texture64" / "texture64-train.pklv4"), small)
    _write_pklv4(str(tmp_path / "src" / "texture160" / "texture160-train.pklv4"), big)
    out = score_sde.write_twin_folders(str(tmp_path / "out"), str(tmp_path / "src"))
    flat = sorted(os.listdir(os.path.join(out, score_sde.TEXTURE64_FOLDER)))
    assert flat == [f"{i:05d}.png" for i in range(5)]
    np.testing.assert_array_equal(np.asarray(Image.open(os.path.join(out, score_sde.TEXTURE64_FOLDER, flat[2]))), small[2])
    from conditional_score_diffusion_tpu_torch.data.degradations import bicubic_resize_np

    # the MATLAB bicubic (torch's matmuls here, numpy's einsum in the datamodule), rounded to 8 bits
    want = np.clip(np.round(bicubic_resize_np(big.astype(np.float32) / 255.0, 128) * 255.0), 0, 255)
    got = np.asarray(Image.open(os.path.join(out, score_sde.TEXTURE128_FOLDER, "00001.png")))
    assert got.shape == (128, 128, 3) and np.abs(got - want[1]).max() <= 1


# ---- the ``image`` datamodule ------------------------------------------------


def _folder(root, n, shape, seed=1):
    path = os.path.join(root, "imgs")
    os.makedirs(path)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(os.path.join(path, f"im{i:03d}.png"))
    return path


def _datamodules(root, size, crop=False, seed=42):
    jconfig = jax_song.get_default_configs("cifar10")
    tconfig = song.get_default_configs("cifar10")
    for c in (jconfig, tconfig):
        c.data.base_dir, c.data.dataset = root, "imgs"
        c.data.shape = [3, size, size]
        c.seed = seed
        if crop:
            c.data.crop = True
    jdm, tdm = jax_image_folder.ImageDataModule(jconfig), create_datamodule(tconfig)
    jdm.setup()
    tdm.setup()
    return jdm, tdm


@pytest.mark.parametrize("size", [16, 8])
def test_image_datamodule_matches_jax(tmp_path, size):
    """A 40-file folder of 16px images: at 16px read as they are, at 8px
    bicubic-resized; the split and every iterator's batches bit for bit."""
    _folder(str(tmp_path), 40, (16, 16, 3))
    jdm, tdm = _datamodules(str(tmp_path), size)
    for a, b in zip((jdm.train_idx, jdm.val_idx, jdm.test_idx), (tdm.train_idx, tdm.val_idx, tdm.test_idx)):
        np.testing.assert_array_equal(a, b)
    assert (len(tdm.train_idx), len(tdm.val_idx), len(tdm.test_idx)) == (32, 4, 4)
    jit, tit = jdm.train_iterator(5), tdm.train_iterator(5)
    for _ in range(8):  # past the first epoch (6 batches): the reshuffle too
        w, g = next(jit), next(tit)
        assert g.dtype == np.float32 and g.shape == (5, size, size, 3)
        np.testing.assert_array_equal(g, w)
    for name in ("val_iterator", "test_iterator"):
        got, want = list(getattr(tdm, name)(2)), list(getattr(jdm, name)(2))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_image_datamodule_celeba_crop_matches_jax(tmp_path):
    """218 x 178 images: the centre 108 crop, bicubic to 32px, to [-1, 1]."""
    _folder(str(tmp_path), 10, (218, 178, 3), seed=3)
    jdm, tdm = _datamodules(str(tmp_path), 32, crop=True)
    w, g = next(jdm.train_iterator(4)), next(tdm.train_iterator(4))
    np.testing.assert_array_equal(g, w)
    assert g.shape == (4, 32, 32, 3) and g.min() < -0.5 and g.max() > 0.5
    np.testing.assert_array_equal(tdm.load(0), jdm._load(0))


# ---- the CLI and the card's constants -----------------------------------------


def test_cli_trains_a_recipe_by_its_path(tmp_path, monkeypatch):
    """``--config configs/ve/ncsnv2/celeba.py`` from the table (shrunk to nf
    8, 16px, B=4, 2 steps by wrapping the entry), ``--data_path`` at a
    folder named as the recipe's dataset (``CELEBA``)."""
    _folder(str(tmp_path), 12, (20, 20, 3))
    os.rename(str(tmp_path / "imgs"), str(tmp_path / "CELEBA"))
    key = score_sde.recipe_key("configs/ve/ncsnv2/celeba.py")
    real = score_sde.RECIPES[key]

    def toy():
        config = real()
        config.model.nf = 8
        config.data.image_size = config.data.effective_image_size = 16
        config.data.shape = [3, 16, 16]
        config.training.batch_size, config.training.n_iters, config.training.log_freq = 4, 2, 1
        return config

    monkeypatch.setitem(score_sde.RECIPES, key, toy)
    log = str(tmp_path / "log")
    cli.main(["--mode", "train", "--config", "configs/ve/ncsnv2/celeba.py", "--data_path", str(tmp_path),
              "--log_path", log, "--device", "cpu"])
    losses = [(s, v) for t, v, s in read_scalars(os.path.join(log, "scalars.jsonl")) if t == "train_loss"]
    assert [s for s, _ in losses] == [1, 2] and all(np.isfinite(v) for _, v in losses)
    assert os.listdir(os.path.join(log, "checkpoints"))


def test_chip_smoke_score_sde_constants():
    """The NCSN++ twin's FIR calls per forward (meta device) are
    `chip_smoke.py`'s constant; the other twins call no kernel."""
    import chip_smoke

    for label, recipe, _ in chip_smoke.SCORE_SDE_TWINS:
        calls = chip_smoke.per_name(chip_smoke.forward_calls(recipe("x"), chip_smoke.SCORE_SDE_BATCH))
        want = chip_smoke.SCORE_SDE_FIR_PER_FORWARD if recipe is configs.texture32_ncsnpp_cifar10_smld_config else {}
        assert calls == want, label
    assert chip_smoke.score_sde.recipe_key(chip_smoke.SCORE_SDE_CLI_RECIPE) == "ve/ncsnv2/celeba"


def test_image_split_indices_are_jax_s():
    for n, seed in ((10, 0), (1280, 42), (7, 3)):
        split = [0.8, 0.1, 0.1]
        for a, b in zip(jax_image_folder._split_indices(n, split, seed), image_folder.split_indices(n, split, seed)):
            np.testing.assert_array_equal(a, b)
