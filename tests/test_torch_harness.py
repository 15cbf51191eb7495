"""The port's --mode test harness (`eval/harness.py:run_test`) against the
JAX package's `run_test` on the CPU.

A toy recipe: the 64px 4x interpolation recipe cut to 32px (nf=32, ch_mult
(1, 2, 2), one resblock per level), the texture64 test split resized to
32px, 2 batches of 2, draws [2, 3], 3 sampler steps, both models on the
same random weights.  The port replays the JAX key chain's draws (key
``seed + 17``, split once per sampler call, each call's draws in its order
of use), so both sample the same images: the pickled metric dicts agree at
1e-4 relative (PSNR, the mean of per-draw PSNRs, at 1e-3 dB), the printed
lines agree, and the PNG trees have the same names, with pixels within one
level (the port rounds to the nearest level where JAX truncates).
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_port_toy import Replay, jax_sampler_draws, jax_toy_params, reset_jax_dispatch, shrink
from conditional_score_diffusion_tpu.configs.celeba_sr import (
    celeba_sr_interpolation_config as jax_interpolation_config,
)
from conditional_score_diffusion_tpu.eval import harness as jax_harness
from conditional_score_diffusion_tpu_torch import main as cli
from conditional_score_diffusion_tpu_torch.configs import celeba_sr_interpolation_config
from conditional_score_diffusion_tpu_torch.eval.harness import output_dir, run_test
from conditional_score_diffusion_tpu_torch.models.convert import flax_to_state_dict
from conditional_score_diffusion_tpu_torch.training.checkpoint import save_ema

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, BATCHES, DRAWS, STEPS = 2, 2, [2, 3], 3
REL_TOL, PSNR_TOL = 1e-4, 1e-3


def _toy(config, base_log_dir):
    shrink(config)
    config.data.dataset = "texture64"
    config.data.base_dir = os.path.join(REPO, "datasets")
    config.eval.batch_size = BATCH
    config.eval.first_test_batch, config.eval.last_test_batch = 0, BATCHES
    config.eval.draws = list(DRAWS)
    config.eval.p_steps = STEPS
    config.eval.base_log_dir = str(base_log_dir)
    return config


def _tree(base):
    out = {}
    for root, _, files in os.walk(os.path.join(base, "images")):
        for f in files:
            out[os.path.relpath(os.path.join(root, f), base)] = np.asarray(Image.open(os.path.join(root, f)))
    return out


def _hold_lines(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if " --- mean value: " in w:
            head, value = w.rsplit(" ", 1)
            assert g.rsplit(" ", 1)[0] == head and abs(float(g.rsplit(" ", 1)[1]) - float(value)) <= 1e-4 * abs(
                float(value)) + 1e-5, (g, w)
        else:
            assert g == w


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX run_test and the port's on the same weights and noise; their
    results, trees and printed lines."""
    import contextlib
    import io

    tmp = tmp_path_factory.mktemp("harness")
    jconfig = _toy(jax_interpolation_config("ours_NDV"), tmp / "jax")
    config = _toy(celeba_sr_interpolation_config("ours_NDV"), tmp / "port")
    module, params = jax_toy_params(jconfig, seed=3)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_harness, "init_model", lambda config, rng: (module, params))
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            want = jax_harness.run_test(jconfig, str(tmp))
    finally:
        mp.undo()
        reset_jax_dispatch()
    jax_lines = out.getvalue().splitlines()

    key = jax.random.key(jconfig.seed + 17)
    draws = []
    shape = (BATCH, 32, 32, 3)
    for _ in range(BATCHES * len(DRAWS)):
        key, dr = jax.random.split(key)
        draws += [np.asarray(d) for d in jax_sampler_draws(dr, STEPS, shape, use_path=False)]
    ema = save_ema(str(tmp / "ema.pt"), 0, flax_to_state_dict(params))
    out = io.StringIO()
    records = []
    with contextlib.redirect_stdout(out):
        got = run_test(config, "", checkpoint_path=ema, device="cpu", noise=Replay(draws), draw_records=records)
    return dict(want=want, got=got, jax_lines=jax_lines, lines=out.getvalue().splitlines(), records=records,
                jax_base=output_dir(jconfig), base=output_dir(config), config=config, ema=ema)


def test_metrics_match_jax(runs):
    want, got = runs["want"], runs["got"]
    assert list(got) == list(want) == [0.15]
    assert sorted(got[0.15]) == sorted(want[0.15]) == ["consistency", "diversity", "psnr", "ssim"]
    for m, values in want[0.15].items():
        assert len(got[0.15][m]) == len(values) == BATCHES
        for g, w in zip(got[0.15][m], values):
            assert abs(g - w) <= (PSNR_TOL if m == "psnr" else REL_TOL * abs(w)), (m, g, w)


def test_pickle_and_printed_lines_match_jax(runs):
    import pickle

    name = f"0_{BATCHES}.pkl"
    with open(os.path.join(runs["base"], "test_metrics", name), "rb") as f:
        assert pickle.load(f) == runs["got"]
    assert os.path.exists(os.path.join(runs["jax_base"], "test_metrics", name))
    _hold_lines(runs["lines"], runs["jax_lines"])


def test_png_trees_match_jax(runs):
    got, want = _tree(runs["base"]), _tree(runs["jax_base"])
    assert sorted(got) == sorted(want)
    assert len(got) == BATCH * BATCHES * (2 + len(DRAWS))
    for name, w in want.items():
        assert got[name].dtype == np.uint8 and got[name].shape == w.shape
        assert np.abs(got[name].astype(int) - w.astype(int)).max() <= 1, name


def test_draw_records(runs):
    records = runs["records"]
    assert [(r["batch"], r["draw"]) for r in records] == [(b, d) for b in range(BATCHES) for d in DRAWS]
    for b in range(BATCHES):
        mine = [r["psnr"] for r in records if r["batch"] == b]
        assert abs(np.mean(mine) - runs["got"][0.15]["psnr"][b]) <= 1e-9
    assert all(r["seconds"] > 0 for r in records)


def test_cli_test_mode_runs_the_harness(runs, tmp_path, monkeypatch):
    """`--mode test` runs `run_test` on the recipe with the default noise
    (a generator seeded with seed + 17) and writes the same tree."""
    config = copy.deepcopy(runs["config"])
    config.eval.base_log_dir = str(tmp_path)
    config.eval.last_test_batch, config.eval.draws = 1, [2]
    monkeypatch.setattr(cli, "load_config", lambda name: config)
    cli.main(["--mode", "test", "--config", "toy", "--checkpoint_path", runs["ema"], "--device", "cpu"])
    tree = _tree(output_dir(config))
    assert sorted(tree) == sorted(
        os.path.join("images", d, f"{i}.png") for d in ("x_gt", "y_gt", "samples/snr_0.150/draw_2") for i in (1, 2)
    )
    assert os.path.exists(os.path.join(output_dir(config), "test_metrics", "0_1.pkl"))
