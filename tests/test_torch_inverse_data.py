"""The port's data for the inverse problems against the JAX package's, on
synthetic files written by the tests.

* `LRHR_PKLDataset` crops in every split and rotates in the train split,
  batch for batch as JAX's slow path does (one generator, in turn).
* ``--mode compute_dataset_statistics``: the Haar detail mean of the first
  2 train batches of a synthetic 40px `.pklv4` resized to 32, against
  JAX's `compute_dataset_statistics` at 1e-6 of its largest magnitude;
  `load_data_mean` reads it back.
* `General_PKLDataset`'s inpainting and colorization batches of the same
  file (train: flips and squares from one generator; val; test with the
  squares seeded by dataset index, ``eval.use_seed``): masks exactly, the
  pixels at 1e-6.
* ``paired`` and ``DUAL-GLOW`` on PNG and ``.npy`` trees (2-D slices and
  3-D volumes, with and without ``range_x``/``range_y``, train flips):
  every batch of every split exactly.
* The texture twins' tree writers (`configs.inverse_problems`), small.

The JAX batch assembler runs with its C++ extension off, as in
`tests/test_torch_train_data.py`.
"""

import os
import pickle

import jax  # noqa: F401  (the parity files import both frameworks)
import numpy as np
import pytest
import torch
from PIL import Image

from conditional_score_diffusion_tpu.configs import celeba_sr as jax_celeba
from conditional_score_diffusion_tpu.configs import extra as jax_extra
from conditional_score_diffusion_tpu.configs import inverse_problems as jax_inverse
from conditional_score_diffusion_tpu.data import create_datamodule as jax_create_datamodule
from conditional_score_diffusion_tpu.data import native as jax_native
from conditional_score_diffusion_tpu.data import statistics as jax_statistics
from conditional_score_diffusion_tpu_torch import main as cli
from conditional_score_diffusion_tpu_torch.configs import celeba_sr, extra, inverse_problems
from conditional_score_diffusion_tpu_torch.configs import texture160_kxsr_ncsnpp_config
from conditional_score_diffusion_tpu_torch.data import create_datamodule, pkl_datasets, statistics
from conditional_score_diffusion_tpu_torch.data.degradations import sr_degrade

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIXEL_TOL, MEAN_TOL = 1e-6, 1e-6


@pytest.fixture
def no_native(monkeypatch):
    monkeypatch.setattr(jax_native, "load_native", lambda: None)


def write_pkl(base, dataset="synth", size=40, counts=(24, 12, 12), seed=0):
    """``{base}/{dataset}/{dataset}-{phase}.pklv4`` of random uint8 images."""
    rng = np.random.RandomState(seed)
    d = os.path.join(base, dataset)
    os.makedirs(d, exist_ok=True)
    for phase, n in zip(("train", "val", "test"), counts):
        with open(os.path.join(d, f"{dataset}-{phase}.pklv4"), "wb") as f:
            pickle.dump([rng.randint(0, 256, (size, size, 3), dtype=np.uint8) for _ in range(n)], f)
    return base


def sized(config, base, image_size=32, batch=4):
    """``config`` on the synthetic file under ``base`` through
    `General_PKLDataset` at ``image_size``, train and eval batch ``batch``."""
    d = config.data
    d.base_dir, d.dataset, d.datamodule = str(base), "synth", "General_PKLDataset"
    d.image_size = d.effective_image_size = d.target_resolution = image_size
    config.training.batch_size = batch
    config.eval.batch_size = batch
    return config


# ---- LRHR_PKLDataset: crops and rotations ------------------------------------


@pytest.mark.parametrize("phase,use_crop,use_rot", [
    ("train", True, False), ("val", True, False), ("test", True, False), ("train", False, True),
])
def test_lrhr_refuses_crops_and_train_rotations(phase, use_crop, use_rot):
    """Where JAX crops (every split) or rotates (train), the port's batch of
    the same pairs and generator is JAX's exactly (its slow path); the
    refusal these cases once met is gone."""
    from conditional_score_diffusion_tpu.configs.srflow import df2k_config

    rng = np.random.RandomState(3)
    hr = [rng.randint(0, 256, (176, 176, 3), dtype=np.uint8) for _ in range(3)]
    lr = [rng.randint(0, 256, (44, 44, 3), dtype=np.uint8) for _ in range(3)]
    config, jconfig = texture160_kxsr_ncsnpp_config(), df2k_config("direct")
    for c in (config, jconfig):
        c.data.use_crop, c.data.use_rot = use_crop, use_rot
    dm = pkl_datasets.PKLDataModule(config)
    dm._images[phase] = {"hr": hr, "lr": lr}
    jdm = jax_create_datamodule(jconfig)
    jdm.images = {phase: {"hr": hr, "lr": lr}}
    idx = np.array([2, 0, 1])
    got = dm.make_batch_fn(phase)(idx, np.random.default_rng(7))
    want = jdm._make_batch_fn(phase)(idx, np.random.default_rng(7))
    assert got["x"].shape == ((3, 160, 160, 3) if use_crop else (3, 176, 176, 3))
    for k in ("x", "y"):
        np.testing.assert_array_equal(got[k], want[k])


def test_lrhr_rotation_flag_leaves_the_test_split_as_it_is():
    """JAX rotates only the train split: a test split with ``use_rot`` set
    is batched as without it."""
    config = texture160_kxsr_ncsnpp_config()
    config.data.base_dir = os.path.join(REPO, "datasets")
    config.data.use_rot = True
    got = next(pkl_datasets.PKLDataModule(config).iterator("test", 2))
    config.data.use_rot = False
    want = next(pkl_datasets.PKLDataModule(config).iterator("test", 2))
    assert all(np.array_equal(got[k], want[k]) for k in ("x", "y"))


# ---- --mode compute_dataset_statistics ---------------------------------------


def test_statistics_mean_matches_jax(tmp_path, no_native, capsys):
    jbase, tbase = write_pkl(str(tmp_path / "jax")), write_pkl(str(tmp_path / "port"))
    want = jax_statistics.compute_dataset_statistics(sized(jax_celeba.celeba_sr_160_config("ours_NDV"), jbase), 2)
    jax_line = capsys.readouterr().out.strip().replace(jbase, tbase)
    config = sized(celeba_sr.celeba_sr_160_config("ours_NDV"), tbase)
    got = statistics.compute_dataset_statistics(config, max_batches=2, device="cpu")
    assert capsys.readouterr().out.strip() == jax_line
    assert got.dtype == np.float32 and got.shape == want.shape == (16, 16, 9)
    np.testing.assert_allclose(got, want, rtol=0, atol=MEAN_TOL * np.abs(want).max())
    path = os.path.join(tbase, "datasets_mean", "synth_32", "mean.npy")
    assert statistics.mean_path(config) == path and np.array_equal(np.load(path), got)


def test_load_data_mean(tmp_path):
    config = sized(celeba_sr.celeba_sr_160_config("ours_NDV"), tmp_path)
    assert statistics.load_data_mean(config) is None
    config.data.use_data_mean = True
    with pytest.raises(FileNotFoundError, match="run --mode compute_dataset_statistics first"):
        statistics.load_data_mean(config)
    mean = np.random.RandomState(1).randn(16, 16, 9).astype(np.float32)
    os.makedirs(os.path.dirname(statistics.mean_path(config)))
    np.save(statistics.mean_path(config), mean)
    got = statistics.load_data_mean(config)
    want = np.asarray(jax_statistics.load_data_mean(config))
    assert torch.is_tensor(got) and np.array_equal(got.numpy(), mean) and np.array_equal(want, mean)


def test_cli_mode_writes_the_mean(tmp_path):
    write_pkl(str(tmp_path), counts=(8, 4, 4))
    recipe = tmp_path / "recipe.py"
    recipe.write_text(
        "from conditional_score_diffusion_tpu_torch.configs import celeba_sr_160_config\n"
        "def get_config():\n"
        "    c = celeba_sr_160_config('ours_NDV')\n"
        "    c.data.dataset, c.data.datamodule = 'synth', 'General_PKLDataset'\n"
        "    c.data.image_size, c.training.batch_size = 16, 2\n"
        "    return c\n"
    )
    cli.main(["--mode", "compute_dataset_statistics", "--config", str(recipe), "--data_path", str(tmp_path),
              "--device", "cpu"])
    mean = np.load(tmp_path / "datasets_mean" / "synth_16" / "mean.npy")
    assert mean.shape == (8, 8, 9) and np.isfinite(mean).all()


# ---- General_PKLDataset: inpainting and colorization ------------------------


@pytest.mark.parametrize("task", ["inpainting", "colorization"])
def test_general_task_batches_match_jax(tmp_path, no_native, task):
    base = write_pkl(str(tmp_path))
    jconfig = sized(jax_inverse.inverse_problem_config(task, "ours_NDV"), base)
    tconfig = sized(inverse_problems.inverse_problem_config(task, "ours_NDV"), base)
    jdm = jax_create_datamodule(jconfig)
    jdm.setup()
    tdm = create_datamodule(tconfig)
    keys = {"x", "y", "mask"} if task == "inpainting" else {"x", "y"}
    for name in ("train_iterator", "val_iterator", "test_iterator"):
        jit, tit = getattr(jdm, name)(), getattr(tdm, name)()
        for i in range(3):
            want, got = next(jit), next(tit)
            assert set(got) == set(want) == keys, name
            assert got["x"].shape == (4, 32, 32, 3) and got["y"].shape == (4, 32, 32, 1 if task == "colorization" else 3)
            for k in keys:
                assert got[k].dtype == np.float32
                if k == "mask":
                    assert np.array_equal(got[k], want[k]), (name, i)
                else:
                    np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PIXEL_TOL, err_msg=f"{name} {i} {k}")
            if task == "inpainting":
                side = int(np.sqrt(0.25 * 32 * 32))
                assert (got["mask"].sum(axis=(1, 2, 3)) == side * side).all()
                assert np.array_equal(got["y"], got["x"] * (1 - got["mask"]))


def test_seeded_test_masks_follow_the_dataset_index(tmp_path):
    """``eval.use_seed``: each test item's square comes from its own
    generator seeded with its index in the split, whatever the batch size."""
    base = write_pkl(str(tmp_path))
    config = sized(inverse_problems.inverse_problem_config("inpainting", "ours_NDV"), base)
    dm = create_datamodule(config)
    by_4 = np.concatenate([b["mask"] for b in dm.test_iterator(4)])
    by_6 = np.concatenate([b["mask"] for b in dm.test_iterator(6)])
    assert by_4.shape[0] == by_6.shape[0] == 12 and np.array_equal(by_4, by_6)
    assert not np.array_equal(by_4[0], by_4[1])


# ---- paired and DUAL-GLOW ------------------------------------------------------


def write_tree(base, dataset, kind, counts=(5, 3, 3), seed=0):
    """A paired tree: ``png`` RGB images, ``npy2d`` [20, 20] slices or
    ``npy3d`` [12, 12, 4] volumes, values off [0, 1] for the scans."""
    rng = np.random.RandomState(seed)
    for phase, n in zip(("train", "val", "test"), counts):
        for side in ("A", "B"):
            d = os.path.join(base, dataset, phase, side)
            os.makedirs(d, exist_ok=True)
            for i in range(n):
                if kind == "png":
                    Image.fromarray(rng.randint(0, 256, (16, 16, 3), dtype=np.uint8)).save(os.path.join(d, f"{i}.png"))
                else:
                    shape = (20, 20) if kind == "npy2d" else (12, 12, 4)
                    np.save(os.path.join(d, f"{i:03d}.npy"), (rng.rand(*shape) * 300.0 - 20.0).astype(np.float32))
    return base


def paired_configs(base, kind, datamodule, ranges):
    if kind == "png":
        configs = [jax_inverse.inverse_problem_config("image-to-image", "ours_NDV"),
                   inverse_problems.inverse_problem_config("image-to-image", "ours_NDV")]
    else:
        volumetric = kind == "npy3d"
        configs = [jax_extra.mri_to_pet_config(volumetric), extra.mri_to_pet_config(volumetric)]
    for c in configs:
        c.data.base_dir, c.data.dataset, c.data.datamodule = str(base), "pairs", datamodule
        c.training.batch_size, c.eval.batch_size = 2, 2
        if not ranges and "range_x" in c.data:
            del c.data.range_x, c.data.range_y
    return configs


@pytest.mark.parametrize("kind,datamodule,ranges", [
    ("png", "paired", False), ("npy2d", "paired", True), ("npy2d", "DUAL-GLOW", False),
    ("npy3d", "DUAL-GLOW", True), ("npy3d", "paired", False),
])
def test_paired_batches_match_jax(tmp_path, kind, datamodule, ranges):
    base = write_tree(str(tmp_path), "pairs", kind)
    jconfig, tconfig = paired_configs(base, kind, datamodule, ranges)
    jdm, tdm = jax_create_datamodule(jconfig), create_datamodule(tconfig)
    jdm.setup()
    tdm.setup()
    shape = {"png": (2, 16, 16, 3), "npy2d": (2, 20, 20, 1), "npy3d": (2, 12, 12, 4, 1)}[kind]
    flipped = 0
    for name, n in (("train_iterator", 6), ("val_iterator", 1), ("test_iterator", 1)):
        jit, tit = getattr(jdm, name)(), getattr(tdm, name)()
        got, want = [next(tit) for _ in range(n)], [next(jit) for _ in range(n)]
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w) == ["x", "y"]
            for k in ("x", "y"):
                assert g[k].dtype == np.float32 and g[k].shape == shape and np.array_equal(g[k], w[k]), (name, k)
        if name == "train_iterator":  # some items flipped along axis -2, as JAX draws them
            raw = [tdm.load_pair("train", i)[1] for i in range(5)]
            flipped = sum(not any(np.array_equal(x, r) for r in raw) for b in got for x in b["x"])
    assert 0 < flipped < 12
    if kind != "png":
        lo = min(b["x"].min() for b in got)
        assert (lo < 0) == ranges  # the recipe's range, or each scan's own min and max


def test_twin_trees(tmp_path):
    """The twins' writers on a few items: the image-to-image tree (PNG, A the
    4x SR degradation of B) and the MRI->PET slices and volumes (B the luma
    at 96 in [0, 255], A its 4x SR degradation), read by ``paired``."""
    src = os.path.join(REPO, "datasets")
    base = str(tmp_path)
    inverse_problems.write_texture64_paired(base, src, splits=(2, 2, 2))
    for volumetric in (False, True):
        inverse_problems.write_texture_mri_to_pet(base, src, volumetric, splits=(2, 2, 2))
    recipes = [
        (inverse_problems.texture64_i2i_cmde_block_config(base), (2, 64, 64, 3)),
        (inverse_problems.texture_mri_to_pet_slices_block_config(base), (2, 96, 96, 1)),
        (inverse_problems.texture_mri_to_pet_3d_config(base), (2, 96, 96, 16, 1)),
    ]
    for config, shape in recipes:
        config.training.batch_size = config.eval.batch_size = 2
        dm = create_datamodule(config)
        dm.setup()
        batch = next(dm.test_iterator())
        assert batch["x"].shape == batch["y"].shape == shape
        assert 0.0 <= batch["x"].min() and batch["x"].max() <= 1.0
        if config.data.datamodule == "paired" and len(shape) == 4 and shape[-1] == 1:
            np.testing.assert_allclose(batch["y"], sr_degrade(batch["x"], 4), rtol=0, atol=1e-6)
    gt = pkl_datasets.load_pkl_images(os.path.join(src, "texture64", "texture64-test.pklv4"), 6)
    b = np.asarray(Image.open(os.path.join(base, "texture64_i2i", "test", "B", "0001.png")))
    assert np.array_equal(b, gt[5])
