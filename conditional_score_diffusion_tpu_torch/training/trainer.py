"""Host-side training loop (JAX `training/trainer.py`).

`Trainer(config, log_path, checkpoint_path=None, device="cuda")` builds the
recipe's model (the DDPM default init from ``config.seed``), task, train
state, train and eval steps and checkpoint manager; `fit(max_steps=None)`
feeds train batches (made ahead on a background thread), runs the step,
and every

* ``training.log_freq`` steps (and at the first) logs ``train_loss``,
  ``grad_norm``, ``ms_per_step``, ``train_imgs_per_sec`` and
  ``window_steps`` over the sustained window as JAX defines it: the steps
  since the last log, re-anchored after eval and snapshot work, so host
  work never counts as step time (and, for VS-CMDE, ``sigma_max_y`` and
  ``sigma_min_y``);
* ``training.eval_freq`` steps logs ``eval_loss`` on the EMA weights over
  the eval split (``eval.loss_split``, default ``val``, at most
  ``eval.max_val_batches`` batches, 0 for all);
* ``training.snapshot_freq`` steps, and at the last, saves the train state.

The scalars go, with the JAX tags, to ``<log_path>/scalars.jsonl``, one
JSON object ``{"tag", "value", "step"}`` a line (the card has no
TensorBoard).  Callbacks, visualization, sampling during training and the
profiler window wait for ROADMAP.md section 1, item 5.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..data.pkl_datasets import PKLDataModule, PrefetchIterator
from ..models import create_model
from .checkpoint import CheckpointManager
from .schedules import is_decreasing_variance, sigma_y_at_step
from .state import create_train_state
from .steps import make_eval_step, make_train_step, seeded, step_seed
from .tasks import create_task


def to_device(batch, device: torch.device):
    """A host batch (an array, or a dict of arrays) as tensors on ``device``."""
    if isinstance(batch, np.ndarray):
        return torch.from_numpy(batch).to(device)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


class ScalarLog:
    """Append-only JSON-lines scalar log."""

    def __init__(self, path: str):
        self.path = path

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n")


def read_scalars(path: str):
    """The ``(tag, value, step)`` records of a scalar log, in order."""
    with open(path) as f:
        return [(r["tag"], r["value"], r["step"]) for r in map(json.loads, f)]


class Trainer:
    def __init__(self, config, log_path: str, checkpoint_path: Optional[str] = None, device="cuda"):
        self.config = config
        self.log_path = log_path
        self.checkpoint_path = checkpoint_path
        self.device = torch.device(device)
        os.makedirs(log_path, exist_ok=True)

        self.datamodule = PKLDataModule(config)
        with seeded(config.seed, self.device):
            self.model = create_model(config, self.device)
        self.task = create_task(config, self.model)
        self.train_step = make_train_step(config, self.model)
        self.eval_step = make_eval_step(config, self.model)
        self.state = create_train_state(config, self.model)

        self.ckpt = CheckpointManager(os.path.join(log_path, "checkpoints"), max_to_keep=3)
        if checkpoint_path:
            CheckpointManager(checkpoint_path).restore(self.state)
        elif self.ckpt.latest_step() is not None:
            self.ckpt.restore(self.state)
        self.writer = ScalarLog(os.path.join(log_path, "scalars.jsonl"))

    def log_scalar(self, tag: str, value: float, step: int):
        self.writer.add_scalar(tag, value, step)

    def run_eval(self, step: int) -> float:
        """Mean EMA loss over the eval split's batches; batch i draws from
        a generator seeded by ``(seed, step, i)``."""
        max_batches = int(self.config.eval.get("max_val_batches", 0) or 0)
        split = self.config.eval.get("loss_split", "val")
        losses = []
        for i, batch in enumerate(self.datamodule.iterator(split, self.config.eval.batch_size)):
            if max_batches and i >= max_batches:
                break
            batch = to_device(self.task.prepare_batch(batch), self.device)
            gen = torch.Generator(device=self.device).manual_seed(step_seed(self.config.seed + 1, step, i))
            losses.append(float(self.eval_step(self.state, batch, gen)["eval_loss"]))
        return float(np.mean(losses)) if losses else float("nan")

    def fit(self, max_steps: Optional[int] = None) -> Dict[str, Any]:
        config = self.config
        n_iters = max_steps if max_steps is not None else config.training.n_iters
        log_freq = config.training.get("log_freq", 250)
        eval_freq = config.training.get("eval_freq", 2500)
        snapshot_freq = config.training.get("snapshot_freq", 5000)

        train_iter = PrefetchIterator(self.datamodule.train_iterator(), depth=2)
        history = {"train_loss": [], "eval_loss": []}
        self.state.model.train()
        t_last = time.time()
        # The sustained window: steps since the last log, re-anchored after
        # eval/snapshot work so ms_per_step never absorbs host work.
        window_step = self.state.step
        start = self.state.step
        try:
            for step in range(start, n_iters):
                batch = to_device(self.task.prepare_batch(next(train_iter)), self.device)
                metrics = self.train_step(self.state, batch)

                if (step + 1) % log_freq == 0 or step == start:
                    loss = float(metrics["loss"])  # synchronizes with the device
                    history["train_loss"].append((step + 1, loss))
                    self.log_scalar("train_loss", loss, step + 1)
                    self.log_scalar("grad_norm", float(metrics["grad_norm"]), step + 1)
                    if is_decreasing_variance(config):
                        smin, smax = sigma_y_at_step(config, step + 1)
                        self.log_scalar("sigma_max_y", smax, step + 1)
                        self.log_scalar("sigma_min_y", smin, step + 1)
                    dt = time.time() - t_last
                    t_last = time.time()
                    n_window = max(step + 1 - window_step, 1)
                    window_step = step + 1
                    ms_step = dt / n_window * 1e3
                    imgs_s = config.training.batch_size * n_window / dt
                    self.log_scalar("ms_per_step", ms_step, step + 1)
                    self.log_scalar("train_imgs_per_sec", imgs_s, step + 1)
                    self.log_scalar("window_steps", n_window, step + 1)
                    print(
                        f"step {step + 1}: loss={loss:.5f} ({dt:.1f}s, {ms_step:.1f} ms/step, {imgs_s:.1f} img/s)",
                        flush=True,
                    )

                t_host0 = time.time()
                if (step + 1) % eval_freq == 0:
                    eval_loss = self.run_eval(step)
                    history["eval_loss"].append((step + 1, eval_loss))
                    self.log_scalar("eval_loss", eval_loss, step + 1)
                if (step + 1) % snapshot_freq == 0 or (step + 1) == n_iters:
                    self.ckpt.save(self.state.step, self.state)
                if time.time() - t_host0 > 0.05:
                    t_last = time.time()
                    window_step = step + 1
        finally:
            train_iter.close()
        return history


def train(config, log_path: str, checkpoint_path: Optional[str] = None, max_steps: Optional[int] = None,
          device="cuda") -> Dict[str, Any]:
    """`Trainer(...).fit(max_steps)` (JAX `run_lib.train`)."""
    return Trainer(config, log_path, checkpoint_path, device=device).fit(max_steps=max_steps)
