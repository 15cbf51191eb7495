"""The port's `Trainer`, its checkpoints and its command line, on the CPU at
toy size: the flagship recipe cut to 32px (`_torch_port_toy`), batch 2, on
the committed texture160 train split (resized to 32px on the host), with
every 3x3 stride-1 conv through `ops/conv3x3.py` (``conv_dispatch =
'conv3x3_kernel'``; its plain version on the CPU) and the fused tail on in
the EMA eval (the recipe's ``fused_tail``)."""

import math
import os
import textwrap

import jax  # noqa: F401  (the parity files import both frameworks)
import numpy as np
import pytest
import torch

from _torch_port_toy import torch_toy_config
from conditional_score_diffusion_tpu_torch import main as cli
from conditional_score_diffusion_tpu_torch.training.checkpoint import CheckpointManager
from conditional_score_diffusion_tpu_torch.training.trainer import Trainer, read_scalars

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def toy_recipe():
    config = torch_toy_config(fused_tail=True)
    config.data.dataset = "texture160"
    config.data.datamodule = "General_PKLDataset"
    config.data.base_dir = os.path.join(REPO, "datasets")
    config.model.conv_dispatch = "conv3x3_kernel"
    config.training.batch_size = 2
    config.training.log_freq = 1
    config.training.eval_freq = 3
    config.training.snapshot_freq = 2
    config.training.visualization_p_steps = 2  # the recipe's callback fires at the snapshot
    config.eval.batch_size = 2
    config.eval.max_val_batches = 2
    config.optim.warmup = 2
    return config


def test_fit_logs_losses_and_evaluates_the_ema(tmp_path):
    trainer = Trainer(toy_recipe(), str(tmp_path), device="cpu")
    history = trainer.fit(max_steps=3)
    assert [s for s, _ in history["train_loss"]] == [1, 2, 3]
    assert all(math.isfinite(v) for _, v in history["train_loss"])
    assert len(history["eval_loss"]) == 1 and history["eval_loss"][0][0] == 3
    assert math.isfinite(history["eval_loss"][0][1])
    scalars = read_scalars(os.path.join(tmp_path, "scalars.jsonl"))
    tags = {tag for tag, _, _ in scalars}
    assert tags == {"train_loss", "grad_norm", "ms_per_step", "train_imgs_per_sec", "window_steps", "eval_loss"}
    assert [step for tag, _, step in scalars if tag == "window_steps"] == [1, 2, 3]
    assert trainer.state.step == 3 and trainer.state.ema.num_updates == 3
    assert trainer.ckpt.all_steps() == [2, 3]
    assert trainer.model.training  # the EMA eval left the live model in train mode


def test_checkpoint_round_trip_continues_exactly(tmp_path):
    """Train 2 steps (a checkpoint at 2), restore it into a new trainer, and
    take the third step on both: params, EMA and Adam's state agree bit for
    bit with the trainer that was never restored."""
    config = toy_recipe()
    config.training.eval_freq = 10**9
    first = Trainer(config, str(tmp_path / "a"), device="cpu")
    first.fit(max_steps=2)
    restored = Trainer(config, str(tmp_path / "b"), checkpoint_path=first.ckpt.directory, device="cpu")
    assert restored.state.step == 2 and restored.state.scheduler.last_epoch == 2
    first.fit(max_steps=3)
    restored.fit(max_steps=3)
    a, b = first.state, restored.state
    assert a.step == b.step == 3 and a.ema.num_updates == b.ema.num_updates == 3
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(a.ema.params[name], b.ema.params[name]), name
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a.optimizer.state[p][k], b.optimizer.state[q][k]), (name, k)


def test_checkpoints_keep_the_newest(tmp_path):
    trainer = Trainer(toy_recipe(), str(tmp_path), device="cpu")
    mgr = CheckpointManager(str(tmp_path / "keep"), max_to_keep=2)
    for step in (1, 2, 3):
        trainer.state.step = step
        mgr.save(step, trainer.state)
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    assert not [f for f in os.listdir(mgr.directory) if f.endswith(".tmp")]


def test_cli_trains_a_toy_recipe(tmp_path):
    recipe = tmp_path / "toy_recipe.py"
    recipe.write_text(textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {os.path.join(REPO, 'tests')!r})
        from test_torch_trainer import toy_recipe

        def get_config():
            config = toy_recipe()
            config.training.n_iters = 2
            return config
    """))
    log_path = tmp_path / "logs"
    cli.main(["--mode", "train", "--config", str(recipe), "--log_path", str(log_path), "--device", "cpu"])
    assert CheckpointManager(str(log_path / "checkpoints")).latest_step() == 2
    assert [s for t, _, s in read_scalars(str(log_path / "scalars.jsonl")) if t == "train_loss"] == [1, 2]
    data = tmp_path / "data" / "texture160"
    data.mkdir(parents=True)
    (data / "texture160-train.pklv4").symlink_to(os.path.join(REPO, "datasets", "texture160", "texture160-train.pklv4"))
    cli.main(["--mode", "compute_dataset_statistics", "--config", str(recipe), "--data_path", str(data.parent),
              "--device", "cpu"])
    mean = np.load(data.parent / "datasets_mean" / "texture160_32" / "mean.npy")
    assert mean.shape == (16, 16, 9) and mean.dtype == np.float32 and np.isfinite(mean).all()
    with pytest.raises(KeyError, match="texture160_sr_cmde_conv3x3"):
        cli.load_config("no_such_recipe")
    assert cli.load_config("texture160_sr_cmde_conv3x3").model.conv_dispatch == "conv3x3_kernel"
