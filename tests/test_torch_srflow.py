"""The port's DF2K direct 4x recipe, its VS-CMDE sigma_y schedule and its
LR/HR test reader against the JAX package's, and the committed texture160
LQ test file against its derivation from the GT file.

The LQ file is rebuilt with

    python -c "import pickle; from conditional_score_diffusion_tpu_torch.data import degradations as d, \\
pkl_datasets as p; lq = d.bicubic_lq_images(p.load_pkl_images('datasets/texture160/texture160-test.pklv4'), 4); \\
pickle.dump(lq, open('datasets/texture160/texture160-test_X4.pklv4', 'wb'), protocol=4)"
"""

import os
import pickle

import jax  # noqa: F401  (the parity files import both frameworks)
import numpy as np
import pytest
import torch

from conditional_score_diffusion_tpu.configs.srflow import df2k_config as jax_df2k_config
from conditional_score_diffusion_tpu.data import native as jax_native
from conditional_score_diffusion_tpu.data import pkl_datasets as jax_pkl
from conditional_score_diffusion_tpu.training import schedules as jax_schedules
from conditional_score_diffusion_tpu_torch.configs import (
    Config,
    df2k_config,
    texture160_kxsr_ncsnpp_block_config,
    texture160_kxsr_ncsnpp_config,
)
from conditional_score_diffusion_tpu_torch.data import degradations, pkl_datasets
from conditional_score_diffusion_tpu_torch.training import schedules

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LQ_FILE = os.path.join(REPO, "datasets", "texture160", "texture160-test_X4.pklv4")


def _leaves(config, prefix=""):
    for key, value in vars(config).items():
        if isinstance(value, Config):
            yield from _leaves(value, prefix + key + ".")
        else:
            yield prefix + key, value


def _jax_value(config, path):
    node = config
    for key in path.split("."):
        node = node[key]
    return node


def test_df2k_recipe_matches_jax():
    """Every field of the port's recipe holds the JAX recipe's value, and the
    fields the port leaves out are ones no ported module reads."""
    jax_config = jax_df2k_config("direct")
    leaves = dict(_leaves(df2k_config("direct")))
    for path, value in leaves.items():
        want = _jax_value(jax_config, path)
        if isinstance(value, (tuple, list)):
            assert list(value) == list(want), path
        else:
            assert value == want and type(value) is type(want), path
    with pytest.raises(KeyError):
        df2k_config("20to40")
    texture = dict(_leaves(texture160_kxsr_ncsnpp_config()))
    differ = {p for p in leaves if texture[p] != leaves[p]}
    assert differ == {"data.dataset", "eval.batch_size"}  # base_dir is "datasets" in both
    assert texture["data.dataset"] == "texture160" and texture["eval.batch_size"] == 8
    block = texture160_kxsr_ncsnpp_block_config()
    assert block.model.fused_tail and block.model.fused_block


@pytest.mark.parametrize("step", [0, 1, 137, 4000, 8000, 20000])
def test_sigma_y_at_step_matches_jax(step):
    config, jax_config = df2k_config("direct"), jax_df2k_config("direct")
    got = schedules.sigma_y_at_step(config, step)
    want = jax_schedules.sigma_y_at_step(jax_config, step)
    assert got == tuple(float(w) for w in want)
    assert schedules.is_decreasing_variance(config) == jax_schedules.is_decreasing_variance(jax_config) is True
    if step == 8000:  # sigma_y,max at the end of the anneal: half of 160 * sqrt(3)
        assert abs(got[1] - 80 * np.sqrt(3)) < 1e-4


def test_lq_file_is_the_bicubic_of_the_gt_file():
    """The committed LQ file is, byte for byte, the GT test crops resized by
    the dataset script's expression (bicubic to 40, x255, clip, uint8)."""
    gt = pkl_datasets.load_pkl_images(os.path.join(REPO, "datasets", "texture160", "texture160-test.pklv4"))
    lq = degradations.bicubic_lq_images(gt, 4)
    with open(LQ_FILE, "rb") as f:
        assert f.read() == pickle.dumps(lq, protocol=4)
    assert len(lq) == len(gt) == 52 and lq[0].shape == (40, 40, 3) and lq[0].dtype == np.uint8


@pytest.mark.parametrize("upscale_lr", [False, True])
def test_lrhr_test_batches_match_jax(upscale_lr, monkeypatch):
    """The texture160 DF2K recipe's test batches, in order, against the JAX
    `LRHR_PKLDataset` test iterator on the same pairs (its numpy batch
    assembly; the C++ one differs by one float32 ulp)."""
    config = texture160_kxsr_ncsnpp_config()
    config.data.base_dir = os.path.join(REPO, "datasets")
    config.data.upscale_lr = upscale_lr
    got = list(pkl_datasets.iter_test_batches(config))
    assert len(got) == 6 and got[0]["x"].shape == (8, 160, 160, 3)
    assert got[0]["y"].shape == ((8, 160, 160, 3) if upscale_lr else (8, 40, 40, 3))

    jax_config = jax_df2k_config("direct")
    jax_config.data.dataset, jax_config.data.base_dir = "texture160", config.data.base_dir
    jax_config.eval.batch_size, jax_config.data.upscale_lr = 8, upscale_lr
    paths = jax_pkl.pkl_paths(jax_config, "test")
    module = jax_pkl.LRHRPKLDataModule(jax_config)
    module.images = {"test": {"lr": jax_pkl.load_pkl_images(paths["LQ"]), "hr": jax_pkl.load_pkl_images(paths["GT"])}}
    monkeypatch.setattr(jax_native, "load_native", lambda: None)
    want = list(module.test_iterator())
    assert len(want) == len(got)
    for g, w in zip(got, want):
        for k in ("x", "y"):
            assert g[k].dtype == w[k].dtype == np.float32
            np.testing.assert_array_equal(g[k], w[k])
