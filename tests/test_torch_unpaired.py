"""The unconditional and decreasing-variance recipes through the port's
data and `Trainer` on the CPU.

* `unpaired_PKLDataset`: the texture160 unconditional recipe's train
  batches (shuffled, each image flipped by its own draw, resized bicubic
  from 160 to 128) and its first test batch, exactly as JAX
  `UnpairedPKLDataModule` makes them.
* `Trainer.fit` on an unconditional 16px NCSN++ through those batches (a
  bare array, not a dict), with an EMA eval and a checkpoint, and the same
  through the command line from a recipe file.
* `Trainer.fit` on the toy VS-CMDE recipe: the logged sigma_max_y and
  sigma_min_y at each step are the schedule's.
"""

import math
import os
import textwrap

import jax  # noqa: F401  (the parity files import both frameworks)
import numpy as np
import pytest
import torch

from _torch_port_toy import ncsnpp_toy_config, shrink
from conditional_score_diffusion_tpu.configs.extra import unconditional_pkl_config as jax_unconditional_config
from conditional_score_diffusion_tpu.data import pkl_datasets as jax_pkl
from conditional_score_diffusion_tpu_torch import main as cli
from conditional_score_diffusion_tpu_torch.configs import base as torch_base
from conditional_score_diffusion_tpu_torch.configs import celeba_sr_160_config, texture160_unconditional_ncsnpp_config
from conditional_score_diffusion_tpu_torch.data.pkl_datasets import PKLDataModule
from conditional_score_diffusion_tpu_torch.training.checkpoint import CheckpointManager
from conditional_score_diffusion_tpu_torch.training.schedules import sigma_y_at_step
from conditional_score_diffusion_tpu_torch.training.trainer import Trainer, read_scalars

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "datasets")


def test_unpaired_batches_match_jax():
    jconfig = jax_unconditional_config(128)
    jconfig.data.dataset, jconfig.data.base_dir = "texture160", DATA
    tconfig = texture160_unconditional_ncsnpp_config()
    tconfig.data.base_dir = DATA
    jdm = jax_pkl.UnpairedPKLDataModule(jconfig)
    jdm.setup()
    tdm = PKLDataModule(tconfig)
    for it_j, it_t, n in ((jdm.train_iterator(4), tdm.train_iterator(4), 3), (jdm.test_iterator(8), tdm.test_iterator(8), 1)):
        for i in range(n):
            want, got = next(it_j), next(it_t)
            assert isinstance(got, np.ndarray) and got.shape == (want.shape[0], 128, 128, 3), i
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)


def unconditional_toy_recipe():
    config = ncsnpp_toy_config(torch_base)
    config.training.lightning_module = "base"
    config.training.likelihood_weighting = False
    config.training.reduce_mean = False
    config.data.dataset, config.data.base_dir = "texture160", DATA
    config.data.datamodule, config.data.use_flip = "unpaired_PKLDataset", True
    config.model.sigma_max, config.model.sigma_min = math.sqrt(3 * 16 * 16), 5e-3
    config.training.batch_size = 2
    config.training.log_freq = 1
    config.training.eval_freq = 3
    config.training.snapshot_freq = 2
    config.training.visualization_p_steps = 2  # the recipe's callback fires at the snapshot
    config.eval.batch_size = 2
    config.eval.max_val_batches = 1
    config.eval.loss_split = "test"
    return config


def test_unconditional_fit(tmp_path):
    trainer = Trainer(unconditional_toy_recipe(), str(tmp_path), device="cpu")
    history = trainer.fit(max_steps=3)
    assert [s for s, _ in history["train_loss"]] == [1, 2, 3]
    assert all(math.isfinite(v) for _, v in history["train_loss"])
    assert len(history["eval_loss"]) == 1 and math.isfinite(history["eval_loss"][0][1])
    assert trainer.ckpt.all_steps() == [2, 3] and trainer.state.ema.num_updates == 3
    restored = Trainer(unconditional_toy_recipe(), str(tmp_path / "b"), checkpoint_path=trainer.ckpt.directory,
                       device="cpu")
    for (name, p), q in zip(trainer.model.named_parameters(), restored.model.parameters()):
        assert torch.equal(p, q), name
    samples, info = trainer.task.sampling_fn((2, 16, 16, 3), p_steps=2)(
        torch.Generator().manual_seed(0), trainer.model, show_evolution=True
    )
    assert samples.shape == (2, 16, 16, 3) and info["evolution"].shape == (2, 2, 16, 16, 3)


def test_cli_trains_an_unconditional_recipe(tmp_path):
    recipe = tmp_path / "unconditional_recipe.py"
    recipe.write_text(textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {os.path.join(REPO, 'tests')!r})
        from test_torch_unpaired import unconditional_toy_recipe

        def get_config():
            config = unconditional_toy_recipe()
            config.training.n_iters = 2
            return config
    """))
    log_path = tmp_path / "logs"
    cli.main(["--mode", "train", "--config", str(recipe), "--log_path", str(log_path), "--device", "cpu"])
    assert CheckpointManager(str(log_path / "checkpoints")).latest_step() == 2
    assert [s for t, _, s in read_scalars(str(log_path / "scalars.jsonl")) if t == "train_loss"] == [1, 2]


@pytest.mark.parametrize("approach", ["ours_DV", "ours_slowDV"])
def test_decreasing_variance_fit_logs_the_schedule(tmp_path, approach):
    config = shrink(celeba_sr_160_config(approach))
    config.data.dataset, config.data.base_dir, config.data.datamodule = "texture160", DATA, "General_PKLDataset"
    config.training.batch_size, config.training.log_freq, config.training.eval_freq = 2, 1, 10**9
    config.model.reach_target_steps = 2
    Trainer(config, str(tmp_path), device="cpu").fit(max_steps=3)
    scalars = read_scalars(os.path.join(tmp_path, "scalars.jsonl"))
    for tag, index in (("sigma_min_y", 0), ("sigma_max_y", 1)):
        logged = [(step, value) for t, value, step in scalars if t == tag]
        assert logged == [(s, sigma_y_at_step(config, s)[index]) for s in (1, 2, 3)], tag
    assert logged[1] == (2, np.float32(config.model.sigma_max_y_target))  # reached at reach_target_steps
