"""The port's host data of the multi-scale recipes against the JAX
package's, on files the tests write.

* `data/builder.py`: the Haar trees of an image folder (PNGs and JPGs, some
  resized by PIL) and the edges2shoes A/B trees, and the config-driven
  `create_dataset`, against JAX's: the same file lists, the same
  PNG / JPG bytes, the same ``.npy`` arrays (1e-6 of their largest
  magnitude; they are bit for bit, as `ops/haar.py` is), the same printed
  coefficient ranges.
* ``haar_multiscale`` at levels 0 and 1 on those trees, and
  ``bicubic_multiscale`` (train crops, centred eval crops, the bicubic
  pyramid level) on a JPG folder: every batch of the shuffled train split
  (two epochs) and of val and test in order, bit for bit against JAX's;
  celebA's fixed split on a list of 182,640 names, exactly.
* `LRHR_PKLDataset` with ``use_crop`` / ``use_rot`` / ``use_flip`` on a
  written `.pklv4` pair: the train iterator (crop, flip and rotation from
  one generator) and the val split (crop only), exactly.
"""

import glob
import os
import pickle

import jax  # noqa: F401  (the parity files import both frameworks)
import ml_collections
import numpy as np
import pytest
import torch
from PIL import Image

from conditional_score_diffusion_tpu.configs.srflow import df2k_config as jax_df2k_config
from conditional_score_diffusion_tpu.data import builder as jax_builder
from conditional_score_diffusion_tpu.data import create_datamodule as jax_create_datamodule
from conditional_score_diffusion_tpu.data import native as jax_native
from conditional_score_diffusion_tpu.data import sr_multiscale as jax_sr_multiscale
from conditional_score_diffusion_tpu_torch.configs import texture160_kxsr_ncsnpp_config
from conditional_score_diffusion_tpu_torch.data import builder, create_datamodule, sr_multiscale

torch.set_num_threads(1)

ARRAY_TOL = 1e-6


def write_images(d, n=12, size=16, seed=0):
    """``n`` random RGB images under ``d``: PNGs and JPGs, every third one
    at another size, so that it is resized."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(n):
        s = size + 4 if i % 3 == 0 else size
        img = Image.fromarray(rng.randint(0, 256, (s, s, 3), dtype=np.uint8))
        img.save(os.path.join(d, f"{i:03d}.{'jpg' if i % 2 else 'png'}"))
    return d


def tree(root):
    return sorted(os.path.relpath(p, root) for p in glob.glob(os.path.join(root, "**", "*.*"), recursive=True))


def assert_same_trees(got_root, want_root):
    files = tree(want_root)
    assert files and tree(got_root) == files
    for name in files:
        got, want = os.path.join(got_root, name), os.path.join(want_root, name)
        if name.endswith(".npy"):
            g, w = np.load(got), np.load(want)
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert np.abs(g - w).max() <= ARRAY_TOL * np.abs(w).max(), name
        else:
            with open(got, "rb") as f, open(want, "rb") as h:
                assert f.read() == h.read(), name


def build_both(tmp_path, fn, capsys, **kwargs):
    """``fn`` of both packages into ``port/`` and ``jax/``; returns their
    results and printed lines."""
    out = {}
    for name, module in (("port", builder), ("jax", jax_builder)):
        result = getattr(module, fn)(out_base=str(tmp_path / name), **kwargs)
        out[name] = (result, capsys.readouterr().out)
    return out


@pytest.mark.parametrize("max_depth", [1, 2])
def test_haar_builder_matches_jax(tmp_path, capsys, max_depth):
    src = write_images(str(tmp_path / "raw"))
    out = build_both(tmp_path, "create_haar_dataset", capsys, src_dir=src, dataset_name="celebA", image_size=16,
                     max_depth=max_depth, split=(0.5, 0.25, 0.25), seed=3, batch=5)
    assert out["port"] == out["jax"]
    assert_same_trees(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert len(glob.glob(str(tmp_path / "port" / f"celebA_{16 >> max_depth}" / "train" / "*.npy"))) == 6


def test_ab_builder_and_dispatch_match_jax(tmp_path, capsys):
    rng = np.random.RandomState(1)
    ab = tmp_path / "shoes_AB"
    ab.mkdir()
    for i in range(10):
        Image.fromarray(rng.randint(0, 256, (24, 48, 3), dtype=np.uint8)).save(ab / f"{i}_AB.jpg")
    out = build_both(tmp_path, "create_ab_paired_dataset", capsys, master_path=str(ab), resize_size=16, seed=5)
    assert out["port"][1].endswith(f"{tmp_path / 'port'}\n") and out["jax"][1].endswith(f"{tmp_path / 'jax'}\n")
    assert_same_trees(str(tmp_path / "port"), str(tmp_path / "jax"))

    # create_dataset: the Haar trees of data.base_dir/data.dataset, as the recipe names them
    from conditional_score_diffusion_tpu_torch.configs import Config

    src = write_images(str(tmp_path / "faces"), n=8)
    data = dict(dataset="faces", datamodule="haar_multiscale", target_resolution=16, max_haar_depth=1,
                split=[0.5, 0.25, 0.25])
    for name, module in (("port", builder), ("jax", jax_builder)):
        base = tmp_path / f"recipe_{name}"
        base.mkdir()
        os.symlink(src, base / "faces")
        if name == "port":
            config = Config(seed=4, data=Config(base_dir=str(base), **data))
        else:
            config = ml_collections.ConfigDict(dict(seed=4, data=dict(base_dir=str(base), **data)))
        module.create_dataset(config)
    capsys.readouterr()
    for d in ("faces_16", "faces_8"):
        assert_same_trees(str(tmp_path / "recipe_port" / d), str(tmp_path / "recipe_jax" / d))


def _haar_configs(base, image_size, level, batch=2):
    data = dict(base_dir=base, dataset="celebA", datamodule="haar_multiscale", image_size=image_size, level=level)
    jc = ml_collections.ConfigDict(dict(seed=7, training=dict(batch_size=batch), eval=dict(batch_size=batch), data=data))
    from test_torch_multiscale import port_config

    return port_config(jc), jc


@pytest.mark.parametrize("image_size,level", [(16, 0), (8, 1.0)])
def test_haar_multiscale_batches_match_jax(tmp_path, image_size, level):
    src = write_images(str(tmp_path / "raw"), n=16)
    builder.create_haar_dataset(src, str(tmp_path), "celebA", 16, max_depth=1, split=(0.5, 0.25, 0.25), seed=0)
    config, jconfig = _haar_configs(str(tmp_path), image_size, level)
    dm, jdm = create_datamodule(config), jax_create_datamodule(jconfig)
    dm.setup()
    jdm.setup()
    train, jtrain = dm.train_iterator(), jdm.train_iterator()
    for _ in range(8):  # two epochs of 4 batches: the shuffle of each
        g, w = next(train), next(jtrain)
        assert g.shape == (2, image_size, image_size, 3) and g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    for name in ("val_iterator", "test_iterator"):
        got, want = list(getattr(dm, name)()), list(getattr(jdm, name)())
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_celeba_split_matches_jax():
    paths = [f"{i:06d}.jpg" for i in range(182640)]
    for phase in ("train", "val", "test"):
        rng, jrng = np.random.default_rng(3), np.random.default_rng(3)
        got, want = sr_multiscale.celeba_split(paths, phase, rng), jax_sr_multiscale.celeba_split(paths, phase, jrng)
        assert list(got) == list(want)
        assert len(got) == (162770 if phase == "train" else 5000)


@pytest.mark.parametrize("level", [0, 1])
def test_bicubic_multiscale_batches_match_jax(tmp_path, level):
    folder = tmp_path / "celebA"
    folder.mkdir()
    rng = np.random.RandomState(2)
    for i in range(14):
        h, w = (24, 20) if i % 2 else (16, 16)
        Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(folder / f"{i:06d}.jpg", quality=90)
    data = dict(base_dir=str(tmp_path), dataset="celebA", datamodule="bicubic_multiscale", target_resolution=16,
                level=level)
    jconfig = ml_collections.ConfigDict(dict(seed=5, training=dict(batch_size=3), eval=dict(batch_size=2), data=data))
    from test_torch_multiscale import port_config

    dm, jdm = create_datamodule(port_config(jconfig)), jax_create_datamodule(jconfig)
    dm.setup()
    jdm.setup()
    assert dm.phase_paths == jdm.phase_paths and len(dm.phase_paths["train"]) == 14
    # celebA's val and test lie past file 162,770: here both read the folder's last images
    split = {"train": dm.phase_paths["train"], "val": dm.phase_paths["train"][8:], "test": dm.phase_paths["train"][:5]}
    dm.phase_paths, jdm.phase_paths = dict(split), dict(split)
    train, jtrain = dm.train_iterator(), jdm.train_iterator()
    for _ in range(8):  # two epochs of 4 batches of random crops
        g, w = next(train), next(jtrain)
        assert g["x"].shape == (3, 16 >> level, 16 >> level, 3) and g["y"].shape == (3, 8 >> level, 8 >> level, 3)
        for k in ("x", "y"):
            np.testing.assert_array_equal(g[k], w[k])
    for name, n in (("val_iterator", 3), ("test_iterator", 2)):
        got, want = list(getattr(dm, name)()), list(getattr(jdm, name)())
        assert len(got) == len(want) == n
        for g, w in zip(got, want):
            for k in ("x", "y"):
                np.testing.assert_array_equal(g[k], w[k])


@pytest.fixture
def no_native(monkeypatch):
    """JAX's batch assembly in numpy (its C++ extension rounds one ulp away)."""
    monkeypatch.setattr(jax_native, "load_native", lambda: None)


def _write_lrhr(base, n=6, size=48, scale=4, seed=4):
    rng = np.random.RandomState(seed)
    d = os.path.join(base, "pairs")
    os.makedirs(d)
    for phase in ("train", "val", "test"):
        hr = [rng.randint(0, 256, (size, size, 3), dtype=np.uint8) for _ in range(n)]
        lr = [rng.randint(0, 256, (size // scale, size // scale, 3), dtype=np.uint8) for _ in range(n)]
        for name, images in ((f"pairs-{phase}.pklv4", hr), (f"pairs-{phase}_X{scale}.pklv4", lr)):
            with open(os.path.join(d, name), "wb") as f:
                pickle.dump(images, f)


@pytest.mark.parametrize("use_crop,use_rot,use_flip,upscale_lr", [
    (True, True, True, False), (True, False, False, True), (False, True, True, False),
])
def test_lrhr_augmented_batches_match_jax(tmp_path, no_native, use_crop, use_rot, use_flip, upscale_lr):
    _write_lrhr(str(tmp_path))
    config, jconfig = texture160_kxsr_ncsnpp_config(), jax_df2k_config("direct")
    for c in (config, jconfig):
        d = c.data
        d.base_dir, d.dataset, d.image_size, d.scale = str(tmp_path), "pairs", 32, 4
        d.use_crop, d.use_rot, d.use_flip, d.upscale_lr = use_crop, use_rot, use_flip, upscale_lr
        c.training.batch_size, c.eval.batch_size, c.seed = 2, 2, 11
    from conditional_score_diffusion_tpu_torch.data import pkl_datasets

    dm, jdm = pkl_datasets.PKLDataModule(config), jax_create_datamodule(jconfig)
    jdm.setup()
    train, jtrain = dm.train_iterator(), jdm.train_iterator()
    for _ in range(6):  # two epochs
        g, w = next(train), next(jtrain)
        for k in ("x", "y"):
            np.testing.assert_array_equal(g[k], w[k])
    size = 32 if use_crop else 48
    assert g["x"].shape == (2, size, size, 3) and g["y"].shape[1] == (size if upscale_lr else size // 4)
    got, want = list(dm.val_iterator()), list(jdm.val_iterator())
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in ("x", "y"):
            np.testing.assert_array_equal(g[k], w[k])
