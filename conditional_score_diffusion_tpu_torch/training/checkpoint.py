"""Checkpoints of the whole train state with `torch.save` (JAX
`training/checkpoint.py`, which writes orbax trees).

One file per saved step, ``<directory>/checkpoint_<step>.pt``, holding the
model's parameters, the EMA shadow and its ``num_updates``, Adam's state
(per-parameter ``exp_avg``, ``exp_avg_sq``, ``step``), the schedule's count
and the step; the newest ``max_to_keep`` are kept.  A file is written under
a temporary name and renamed, so a crash never leaves a torn checkpoint.
Restoring into a state built from the same recipe continues bit for bit on
the same device (`training/steps.py` derives every draw from the step).

For evaluation, :func:`save_ema` writes an EMA-only file ``{step, ema}``
(float32, as trained; `tests/_torch_port_convert_texture64.py` writes the
trained texture64 checkpoint's so), and :func:`load_eval_weights` reads the
weights to evaluate from such a file or from a directory of train
checkpoints (the newest one's EMA).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import torch

from .state import TrainState

_NAME = re.compile(r"^checkpoint_(\d+)\.pt$")


def state_dict(state: TrainState) -> dict:
    return {
        "step": state.step,
        "model": state.model.state_dict(),
        "ema": {"decay": state.ema.decay, "num_updates": state.ema.num_updates, "params": state.ema.params},
        "optimizer": state.optimizer.state_dict(),
        "scheduler": state.scheduler.state_dict(),
    }


def load_state_dict(state: TrainState, saved: dict) -> TrainState:
    """Load ``saved`` into ``state`` in place (tensors copied to the
    state's devices)."""
    state.model.load_state_dict(saved["model"])
    with torch.no_grad():
        for name, shadow in state.ema.params.items():
            shadow.copy_(saved["ema"]["params"][name])
    state.ema.decay = float(saved["ema"]["decay"])
    state.ema.num_updates = int(saved["ema"]["num_updates"])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.scheduler.load_state_dict(saved["scheduler"])
    state.step = int(saved["step"])
    return state


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"checkpoint_{step}.pt")

    def all_steps(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState) -> str:
        os.makedirs(self.directory, exist_ok=True)
        path = self.path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(state_dict(state), tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[: -self.max_to_keep]:
            os.remove(self.path(old))
        return path

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        # loaded on the CPU: the load_state_dict calls copy to the state's
        # devices, and Adam's step counts stay CPU scalars as torch keeps them
        return load_state_dict(state, torch.load(self.path(step), map_location="cpu", weights_only=True))


def save_ema(path: str, step: int, ema: Dict[str, torch.Tensor]) -> str:
    """Write an EMA-only file ``{'step', 'ema'}``; every tensor must be
    float32 (nothing is cast down)."""
    for name, t in ema.items():
        if t.dtype != torch.float32:
            raise TypeError(f"EMA tensor {name} is {t.dtype}; an EMA file holds float32")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"step": int(step), "ema": {k: t.detach().cpu().contiguous() for k, t in ema.items()}}, tmp)
    os.replace(tmp, path)
    return path


def load_eval_weights(path: str) -> Tuple[int, Dict[str, torch.Tensor]]:
    """``(step, state_dict)`` of the EMA weights at ``path``: an EMA-only
    file (:func:`save_ema`), or a directory of train checkpoints, whose
    newest one's model entry (for buffers) is overlaid with its EMA."""
    if os.path.isdir(path):
        mgr = CheckpointManager(path)
        step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {path}")
        saved = torch.load(mgr.path(step), map_location="cpu", weights_only=True)
        weights = dict(saved["model"])
        weights.update(saved["ema"]["params"])
        return int(saved["step"]), weights
    saved = torch.load(path, map_location="cpu", weights_only=True)
    return int(saved["step"]), saved["ema"]
