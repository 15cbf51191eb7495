"""The port's --mode test harness and evaluation pipeline on the inpainting
recipe against the JAX package's, on the CPU.

The inpainting CMDE recipe cut to 32px (`_torch_port_toy.shrink`: nf=32,
ch_mult (1, 2, 2)), the texture160 GT resized to 32px, test batch 1 (of 2
images; its squares seeded by dataset index, ``eval.use_seed``), draws [1, 2], 3
steps, both models on the same random weights and the port fed the JAX key
chain's draws: the pickled metrics (PSNR, SSIM, the known-region
consistency from the batch's ``mask``, diversity) at 1e-4 relative, PSNR at
1e-3 dB.  Then the pipeline on the port's tree re-rolls each image's mask
from its PNG number: exactly the batch's masks.  JAX's pipeline would add
``first_test_batch * batch_size`` to the seeds again (its
`run_lib._evaluate_one_config`); past batch 0 those are other squares.
"""

import os

import jax
import numpy as np
import pytest
import torch

from _torch_port_toy import Replay, jax_sampler_draws, jax_toy_params, reset_jax_dispatch, shrink
from conditional_score_diffusion_tpu.configs.inverse_problems import inverse_problem_config as jax_inverse_config
from conditional_score_diffusion_tpu.data import native as jax_native
from conditional_score_diffusion_tpu.eval import harness as jax_harness
from conditional_score_diffusion_tpu_torch import main as cli
from conditional_score_diffusion_tpu_torch.configs import inverse_problem_config
from conditional_score_diffusion_tpu_torch.data import create_datamodule
from conditional_score_diffusion_tpu_torch.data.degradations import random_square_mask
from conditional_score_diffusion_tpu_torch.eval import pipeline
from conditional_score_diffusion_tpu_torch.eval.harness import run_test
from conditional_score_diffusion_tpu_torch.models.convert import flax_to_state_dict
from conditional_score_diffusion_tpu_torch.training.checkpoint import save_ema

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, DRAWS, STEPS = 2, [1, 2], 3
REL_TOL, PSNR_TOL = 1e-4, 1e-3


def _toy(config, base_log_dir):
    shrink(config)
    config.data.dataset, config.data.base_dir = "texture160", os.path.join(REPO, "datasets")
    config.eval.batch_size = BATCH
    config.eval.first_test_batch, config.eval.last_test_batch = 1, 2
    config.eval.draws, config.eval.p_steps = list(DRAWS), STEPS
    config.eval.evaluation_metrics = ["psnr", "ssim", "consistency", "diversity"]
    config.eval.base_log_dir = str(base_log_dir)
    return config


def test_inpainting_harness_and_pipeline(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_native, "load_native", lambda: None)
    jconfig = _toy(jax_inverse_config("inpainting", "ours_NDV"), tmp_path / "jax")
    config = _toy(inverse_problem_config("inpainting", "ours_NDV"), tmp_path / "port")
    module, params = jax_toy_params(jconfig, seed=4)
    monkeypatch.setattr(jax_harness, "init_model", lambda config, rng: (module, params))
    try:
        want = jax_harness.run_test(jconfig, str(tmp_path))
    finally:
        reset_jax_dispatch()

    key = jax.random.key(jconfig.seed + 17)
    draws = []
    for _ in DRAWS:
        key, dr = jax.random.split(key)
        draws += [np.asarray(d) for d in jax_sampler_draws(dr, STEPS, (BATCH, 32, 32, 3), use_path=False)]
    ema = save_ema(str(tmp_path / "ema.pt"), 0, flax_to_state_dict(params))
    got = run_test(config, "", checkpoint_path=ema, device="cpu", noise=Replay(draws))
    assert sorted(got[0.15]) == sorted(want[0.15]) == ["consistency", "diversity", "psnr", "ssim"]
    for m, values in want[0.15].items():
        (g,), (w,) = got[0.15][m], values
        assert np.isfinite(g) and abs(g - w) <= (PSNR_TOL if m == "psnr" else REL_TOL * abs(w)), (m, g, w)

    rerolled = []
    real = pipeline.random_square_mask
    monkeypatch.setattr(pipeline, "random_square_mask", lambda *a, **k: rerolled.append(real(*a, **k)) or rerolled[-1])
    result = cli.evaluation_pipeline(config, device="cpu")[0.15]
    batch1 = list(create_datamodule(config).test_iterator())[1]
    assert len(rerolled) == 1 and np.array_equal(rerolled[0], batch1["mask"])
    assert sorted(result["per_draw"]) == ["draw_1", "draw_2"] and all(
        np.isfinite(v["consistency"]) for v in result["per_draw"].values())
    jax_seeds = np.arange(BATCH) + 2 * BATCH  # the JAX offset on top of the PNG numbers
    assert not np.array_equal(random_square_mask(rerolled[0].shape, 0.25, None, seeds=jax_seeds), rerolled[0])


@pytest.mark.parametrize("task", ["colorization", "image-to-image"])
def test_consistency_of_other_tasks(task):
    """Colorization has no forward-operator consistency (the pipeline lists
    it as skipped, as JAX's); image-to-image's compares Canny edges (cv2
    imports here)."""
    from conditional_score_diffusion_tpu_torch.eval.metrics import ConsistencyUnavailable, get_consistency_fn

    if task == "colorization":
        with pytest.raises(NotImplementedError) as e:
            get_consistency_fn(task)
        assert not isinstance(e.value, ConsistencyUnavailable)
    else:
        x = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
        assert get_consistency_fn(task)(torch.from_numpy(x), torch.from_numpy(x)) == float("inf")
