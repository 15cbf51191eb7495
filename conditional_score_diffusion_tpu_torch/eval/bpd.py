"""Bits/dim over a data split (JAX `eval/bpd.py`): the probability-flow ODE
likelihood (`sampling/likelihood.py`) of the model's EMA weights, batch by
batch, averaged over the images."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..models.wrappers import get_score_fn
from ..sampling import get_likelihood_fn
from ..sampling.pc import NoiseSource
from ..sde import build_sde


def evaluate_bpd(
    config,
    model,
    datamodule,
    split: Optional[str] = None,
    max_batches: int = 8,
    device: Union[str, torch.device, None] = None,
    noise: Union[torch.Generator, NoiseSource, None] = None,
) -> float:
    """Mean bits/dim of ``model`` over the first ``max_batches`` batches of
    ``split`` (``eval.bpd_dataset``, default ``test``; any other name reads
    the datamodule's val iterator, as in JAX).

    The probes are drawn from ``noise``, by default a `torch.Generator`
    seeded with ``config.seed + 3`` on the model's device, one probe per
    batch in turn; tests pass a source of their own.
    """
    device = torch.device(device) if device is not None else next(model.parameters()).device
    sde, _ = build_sde(config)
    score_fn = get_score_fn(sde, model, conditional=False, train=False, continuous=config.training.continuous)
    likelihood_fn = get_likelihood_fn(sde)
    split = split or config.eval.get("bpd_dataset", "test")
    it = datamodule.test_iterator() if split == "test" else datamodule.val_iterator()
    if noise is None:
        noise = torch.Generator(device=device).manual_seed(config.seed + 3)
    bpds = []
    for i, batch in enumerate(it):
        if i >= max_batches:
            break
        x = torch.from_numpy(np.asarray(batch["x"] if isinstance(batch, dict) else batch)).to(device)
        bpd, _, _ = likelihood_fn(noise, score_fn, x)
        bpds.append(bpd.detach().cpu().numpy())
    assert bpds, "empty split"
    mean_bpd = float(np.concatenate(bpds).mean())
    print(f"[bpd] {split}: {mean_bpd:.4f} bits/dim over {len(bpds)} batches")
    return mean_bpd
