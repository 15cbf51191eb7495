"""The port's offline evaluation pipeline (`eval/pipeline.py`) against the
JAX package's on the CPU, and the PNGs the port's harness writes.

The committed trees of the trained texture64 run (3 draws of 64 images,
`artifacts/texture64_run/evaluation/.../ours_NDV/images`) are copied to a
temporary directory (the pipeline writes `evaluation_info.pkl` beside
them) and evaluated by the port and by JAX `run_evaluation_pipeline`; both
are held against each other and against the committed
`evaluation_info.pkl` at 1e-4 relative (JAX computes in float32, the port
in float64).
"""

import os
import pickle
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from conditional_score_diffusion_tpu.eval.pipeline import _load_images as jax_load_images
from conditional_score_diffusion_tpu.eval.pipeline import run_evaluation_pipeline as jax_pipeline
from conditional_score_diffusion_tpu_torch import main as cli
from conditional_score_diffusion_tpu_torch.configs import texture64_sr_cmde_test_config
from conditional_score_diffusion_tpu_torch.eval.harness import output_dir, save_png
from conditional_score_diffusion_tpu_torch.eval.pipeline import load_images, run_evaluation_pipeline

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = os.path.join(REPO, "artifacts", "texture64_run", "evaluation", "super-resolution", "texture64", "ours_NDV")
REL_TOL = 1e-4


def _copy_trees(dst, n=None):
    """The committed trees under ``dst``: all images, or numbers 1..n."""
    keep = None if n is None else {f"{i}.png" for i in range(1, n + 1)}
    ignore = None if keep is None else (lambda d, names: [f for f in names if f.endswith(".png") and f not in keep])
    shutil.copytree(os.path.join(RUN, "images"), os.path.join(dst, "images"), ignore=ignore)
    return str(dst)


def _hold(got, want):
    assert got["snr"] == want["snr"] and got["n_images"] == want["n_images"] == 64
    assert sorted(got["per_draw"]) == sorted(want["per_draw"]) == ["draw_2", "draw_3", "draw_4"]
    for name, entry in want["per_draw"].items():
        assert sorted(got["per_draw"][name]) == sorted(entry)
        for m, v in entry.items():
            assert abs(got["per_draw"][name][m] - v) <= REL_TOL * abs(v), (name, m, got["per_draw"][name][m], v)
    assert abs(got["diversity"] - want["diversity"]) <= REL_TOL * want["diversity"]


@pytest.fixture(scope="module")
def port_result(tmp_path_factory):
    base = _copy_trees(tmp_path_factory.mktemp("port"))
    result = run_evaluation_pipeline("super-resolution", base, 0.15, scale=4, device="cpu")
    with open(os.path.join(base, "evaluation_info.pkl"), "rb") as f:
        assert pickle.load(f) == result
    return result


def test_pipeline_reproduces_committed_evaluation_info(port_result):
    with open(os.path.join(RUN, "evaluation_info.pkl"), "rb") as f:
        committed = pickle.load(f)
    _hold(port_result, committed)
    assert port_result["skipped"] == committed["skipped"]


def test_pipeline_matches_jax_live(port_result, tmp_path):
    base = _copy_trees(tmp_path)
    want = jax_pipeline("super-resolution", base, 0.15, scale=4)
    _hold(port_result, want)
    assert port_result["skipped"] == want["skipped"]


def test_cli_evaluation_pipeline_over_a_master_config(tmp_path, monkeypatch):
    """`--mode evaluation_pipeline` on a leaf recipe and the same function
    on a master config of two leaves: the trees under each recipe's
    ``eval.base_log_dir`` (4 images of each tree)."""
    config = texture64_sr_cmde_test_config()
    config.eval.base_log_dir = str(tmp_path / "evaluation")
    _copy_trees(output_dir(config), n=4)
    monkeypatch.setattr(cli, "load_config", lambda name: config)
    cli.main(["--mode", "evaluation_pipeline", "--config", "texture64_sr_cmde_test", "--device", "cpu"])
    with open(os.path.join(output_dir(config), "evaluation_info.pkl"), "rb") as f:
        leaf = pickle.load(f)
    assert leaf["n_images"] == 4 and sorted(leaf["per_draw"]) == ["draw_2", "draw_3", "draw_4"]
    master = type(config)(a=config, b=config)
    results = cli.evaluation_pipeline(master, device="cpu")
    assert sorted(results) == ["a", "b"] and results["a"][0.15]["per_draw"] == leaf["per_draw"]


def test_written_pngs_read_back_identically(tmp_path):
    """The harness's PNGs: each value rounded to the nearest of the 256
    levels (ground truth, which sits on the levels, exactly), read back the
    same by PIL, by the port's pipeline and by the JAX pipeline."""
    rng = np.random.RandomState(0)
    imgs = rng.rand(3, 9, 7, 3).astype(np.float32)
    imgs[0] = np.round(imgs[0] * 255.0) / np.float32(255.0)  # on the levels, as a ground-truth image
    imgs[1, 0, 0] = [-0.2, 1.3, 0.5 / 255.0]  # clamped at both ends; about half a level
    paths = [str(tmp_path / f"{i + 1}.png") for i in range(3)]
    for img, p in zip(imgs, paths):
        save_png(img, p)
    want = np.clip(np.floor(imgs * 255.0 + 0.5), 0, 255).astype(np.uint8)
    assert np.array_equal(want[0], np.round(imgs[0] * 255.0).astype(np.uint8))
    pil = np.stack([np.asarray(Image.open(p)) for p in paths])
    assert pil.dtype == np.uint8 and np.array_equal(pil, want)
    assert np.array_equal(load_images(paths), want.astype(np.float32) / 255.0)
    assert np.array_equal(jax_load_images(paths), want.astype(np.float32) / 255.0)
    assert np.array_equal(np.asarray(jnp.asarray(load_images(paths))), jax_load_images(paths))
