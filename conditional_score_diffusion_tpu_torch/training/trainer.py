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

After every step it calls each callback (``fit(callbacks=None)``: the
recipe's, `callbacks.get_callbacks`) with ``(trainer, step)``.  A callback
that raises is printed, counted in ``trainer.callback_failures`` by its
class name, logged as ``callback_failures/<name>`` and its message written
to ``callback_errors.jsonl``; training goes on (JAX: visualization never
kills training).  Callback work, like eval and snapshots, re-anchors the
sustained window.

The datamodule is the recipe's ``data.datamodule`` (`data.create_datamodule`).
The model comes from ``config.seed`` with its default init.

What it writes (`LogWriter`; the card has no TensorBoard), with the JAX
tags: scalars to ``<log_path>/scalars.jsonl``, one JSON object ``{"tag",
"value", "step"}`` a line; images to ``<log_path>/images/<tag>/<step>.png``;
the 2-D samples and the score-norm curve as ``<log_path>/<tag>/<step>.npy``
(the curve's values also as scalars ``score_norm_vs_t/t=<t>``); callback
errors to ``<log_path>/callback_errors.jsonl``.

The profiler window (JAX ``CSDT_PROFILE_DIR``): with that variable set,
`torch.profiler` records steps ``start + 2`` to ``start + 2 +
CSDT_PROFILE_STEPS`` (default 10) on the host and the device, writes a
Chrome trace ``trace_steps_<a>-<b>.json`` into that directory and keeps the
profile as ``trainer.profile`` (its ``key_averages()`` split the window's
device time by kernel).  Its collection is prepared one step earlier (the
warm-up step, whose records are discarded) and a 20 ms host margin
separates each edge from the traced work: without both, a window now and
then loses kernels at its start (`profiling/edges.py`).

Data parallel (a process group of `parallel`, e.g. under ``torchrun``):
every rank makes the same global batches and the steps keep each rank's
rows (`training/steps.py`); the state is broadcast from rank 0 after the
init and after a restore; the eval loss is the mean over the ranks; rank 0
alone writes (scalars, images, checkpoints, callbacks, the profiler trace).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import parallel
from ..data import create_datamodule
from ..data.native import PrefetchIterator
from ..models import create_model
from .callbacks import get_callbacks
from .checkpoint import CheckpointManager
from .schedules import is_decreasing_variance, sigma_y_at_step
from .state import create_train_state
from .steps import make_eval_step, make_train_step, seeded, step_seed
from .tasks import create_task


PROFILE_MARGIN_S = 0.02  # host time between the profiler's window edges and the traced work


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


class LogWriter(ScalarLog):
    """The trainer's writer: the scalar log ``<log_path>/scalars.jsonl``, and
    beside it images, arrays and callback errors under ``log_path``."""

    def __init__(self, log_path: str):
        super().__init__(os.path.join(log_path, "scalars.jsonl"))
        self.log_path = log_path

    def _path(self, tag: str, step: int, ext: str) -> str:
        d = os.path.join(self.log_path, *tag.split("/"))
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, f"{int(step)}.{ext}")

    def add_image(self, tag: str, img_chw: np.ndarray, step: int) -> None:
        """A CHW [0, 1] image as ``images/<tag>/<step>.png`` (8 bits, rounded)."""
        from ..eval.harness import save_png

        save_png(np.transpose(np.asarray(img_chw), (1, 2, 0)), self._path(f"images/{tag}", step, "png"))

    def add_points(self, tag: str, points: np.ndarray, step: int) -> None:
        """An ``[N, D]`` array of points as ``<tag>/<step>.npy``."""
        np.save(self._path(tag, step, "npy"), np.asarray(points, dtype=np.float32))

    def add_curve(self, tag: str, xs: np.ndarray, ys: np.ndarray, step: int) -> None:
        """A curve as ``<tag>/<step>.npy`` (``[2, N]``: x, y) and each point
        as the scalar ``<tag>/t=<x>``."""
        np.save(self._path(tag, step, "npy"), np.stack([np.asarray(xs, np.float64), np.asarray(ys, np.float64)]))
        for x, y in zip(xs, ys):
            self.add_scalar(f"{tag}/t={float(x):.4f}", float(y), step)

    def add_text(self, tag: str, text: str, step: int) -> None:
        """One ``{"tag", "text", "step"}`` line of ``callback_errors.jsonl``."""
        with open(os.path.join(self.log_path, "callback_errors.jsonl"), "a") as f:
            f.write(json.dumps({"tag": tag, "text": str(text), "step": int(step)}) + "\n")


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
        if parallel.is_distributed() and self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())  # cuda:LOCAL_RANK
        os.makedirs(log_path, exist_ok=True)

        self.datamodule = create_datamodule(config)
        self.datamodule.setup()
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
        self.rank = parallel.rank()
        if parallel.is_distributed():
            model = self.state.model
            parallel.broadcast_state([*model.parameters(), *model.buffers(), *self.state.ema.params.values()])
        self.writer = LogWriter(log_path)
        self.callback_failures: Dict[str, int] = {}
        self.profile, self.profile_steps = None, 0

    def log_scalar(self, tag: str, value: float, step: int):
        if self.rank == 0:
            self.writer.add_scalar(tag, value, step)

    def run_eval(self, step: int) -> float:
        """Mean EMA loss over the eval split's batches; batch i draws from
        a generator seeded by ``(seed, step, i)``."""
        max_batches = int(self.config.eval.get("max_val_batches", 0) or 0)
        losses = []
        for i, batch in enumerate(self.datamodule.val_iterator()):
            if max_batches and i >= max_batches:
                break
            batch = to_device(self.task.prepare_batch(batch), self.device)
            gen = torch.Generator(device=self.device).manual_seed(step_seed(self.config.seed + 1, step, i))
            losses.append(float(self.eval_step(self.state, batch, gen)["eval_loss"]))
        return float(np.mean(losses)) if losses else float("nan")

    def fit(self, max_steps: Optional[int] = None, callbacks=None) -> Dict[str, Any]:
        config = self.config
        if callbacks is None:
            callbacks = get_callbacks(config, phase="train")
        profile_dir = os.environ.get("CSDT_PROFILE_DIR")
        profile_steps = int(os.environ.get("CSDT_PROFILE_STEPS", "10"))
        if self.rank:
            callbacks, profile_dir = [], None
        n_iters = max_steps if max_steps is not None else config.training.n_iters
        log_freq = config.training.get("log_freq", 250)
        eval_freq = config.training.get("eval_freq", 2500)
        snapshot_freq = config.training.get("snapshot_freq", 5000)

        train_iter = PrefetchIterator(self.datamodule.train_iterator(), depth=2)
        history = {"train_loss": [], "eval_loss": []}
        self.state.model.train()
        t_last = time.time()
        # The sustained window: steps since the last log, re-anchored after
        # eval/snapshot/callback work so ms_per_step never absorbs host work.
        window_step = self.state.step
        start = self.state.step
        prof, recording = None, False
        try:
            for step in range(start, n_iters):
                if profile_dir and step == start + 1 and n_iters > start + 2:
                    prof = self._prepare_profile()
                if prof is not None and step == start + 2:
                    self._start_profile(prof)
                    recording = True
                if prof is not None and step == start + 2 + profile_steps:
                    self._stop_profile(prof, profile_dir, start + 2, step)
                    prof = profile_dir = None
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
                    if self.rank == 0:
                        print(
                            f"step {step + 1}: loss={loss:.5f} ({dt:.1f}s, {ms_step:.1f} ms/step, {imgs_s:.1f} img/s)",
                            flush=True,
                        )

                t_host0 = time.time()
                if (step + 1) % eval_freq == 0:
                    eval_loss = self.run_eval(step)
                    history["eval_loss"].append((step + 1, eval_loss))
                    self.log_scalar("eval_loss", eval_loss, step + 1)
                if self.rank == 0 and ((step + 1) % snapshot_freq == 0 or (step + 1) == n_iters):
                    self.ckpt.save(self.state.step, self.state)
                for cb in callbacks:
                    self._run_callback(cb, step + 1)
                if time.time() - t_host0 > 0.05:
                    t_last = time.time()
                    window_step = step + 1
        finally:
            train_iter.close()
            if prof is not None and recording:  # the run ended inside the window
                self._stop_profile(prof, profile_dir, start + 2, n_iters)
            elif prof is not None:  # it failed in the warm-up step: nothing to write
                prof.stop()
        return history

    def _run_callback(self, cb, step: int) -> None:
        """``cb(self, step)``; a failure is printed, counted and logged, and
        training goes on (JAX `training/trainer.py`)."""
        try:
            cb(self, step)
        except Exception as e:
            name = type(cb).__name__
            msg = f"{type(e).__name__}: {e}"
            print(f"[callback {name}] {msg}", flush=True)
            self.callback_failures[name] = self.callback_failures.get(name, 0) + 1
            self.log_scalar(f"callback_failures/{name}", self.callback_failures[name], step)
            self.writer.add_text(f"callback_errors/{name}", msg, step)

    def _prepare_profile(self):
        """A profiler whose collection runs from now on; what it records
        before `_start_profile` is discarded."""
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.prepare_trace()
        return prof

    def _start_profile(self, prof) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.start_trace()
        # The warm-up step and a margin between the window's edges and its first and last
        # kernels: on an H100 (700 W) a window that had neither lost some of its first kernels
        # in 79 of 100 windows after the process idled 300 s, with the margin alone in 9 of
        # 100, with both in none of 200 (`profiling/edges.py`).
        time.sleep(PROFILE_MARGIN_S)

    def _stop_profile(self, prof, profile_dir: str, first: int, end: int) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        time.sleep(PROFILE_MARGIN_S)
        prof.stop()
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, f"trace_steps_{first + 1}-{end}.json")
        prof.export_chrome_trace(path)
        self.profile = prof
        self.profile_steps = end - first
        print(f"[profiler] trace of steps {first + 1}-{end} written to {path}", flush=True)


def train(config, log_path: str, checkpoint_path: Optional[str] = None, max_steps: Optional[int] = None,
          device="cuda") -> Dict[str, Any]:
    """`Trainer(...).fit(max_steps)` (JAX `run_lib.train`)."""
    return Trainer(config, log_path, checkpoint_path, device=device).fit(max_steps=max_steps)
