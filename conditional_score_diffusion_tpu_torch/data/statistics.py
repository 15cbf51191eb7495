"""Dataset statistics for ``--mode compute_dataset_statistics`` (JAX
`data/statistics.py`): the mean of the Haar detail coefficients of the train
split, which VESDE's ``data_mean`` prior shift reads.

`compute_dataset_statistics` averages `ops.haar.get_hf_coefficients` of the
first ``max_batches`` train batches on the device (sums in float64) and
writes the float32 mean to
``{data.base_dir}/datasets_mean/{data.dataset}_{data.image_size}/mean.npy``;
`load_data_mean` reads it back where the recipe sets ``data.use_data_mean``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from ..ops.haar import get_hf_coefficients
from . import create_datamodule


def mean_path(config) -> str:
    """Where the recipe's mean is written and read."""
    d = config.data
    return os.path.join(d.base_dir, "datasets_mean", f"{d.dataset}_{d.image_size}", "mean.npy")


def compute_dataset_statistics(
    config, max_batches: int = 200, device: Union[str, torch.device] = "cuda"
) -> np.ndarray:
    """The mean over the train split's first ``max_batches`` batches of
    their Haar detail coefficients, [H/2, W/2, 3C] float32, saved to
    :func:`mean_path`."""
    datamodule = create_datamodule(config)
    datamodule.setup()
    total, count = None, 0
    for i, batch in enumerate(datamodule.train_iterator()):
        if i >= max_batches:
            break
        x = batch["x"] if isinstance(batch, dict) else batch
        hf = get_hf_coefficients(torch.from_numpy(x).to(device))
        part = hf.sum(dim=0, dtype=torch.float64)
        total = part if total is None else total + part
        count += hf.shape[0]
    if count == 0:
        raise ValueError("empty train iterator")
    mean = (total / count).float().cpu().numpy()

    path = mean_path(config)
    Path(os.path.dirname(path)).mkdir(parents=True, exist_ok=True)
    np.save(path, mean)
    print(f"[stats] HF mean over {count} images -> {path} range [{mean.min():.4f}, {mean.max():.4f}]")
    return mean


def load_data_mean(config, device: Union[str, torch.device] = "cpu") -> Optional[torch.Tensor]:
    """The saved mean as a tensor on ``device`` where ``data.use_data_mean``
    is set, else None."""
    if not config.data.get("use_data_mean", False):
        return None
    path = mean_path(config)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"data.use_data_mean=True but {path} not found; run --mode compute_dataset_statistics first"
        )
    return torch.from_numpy(np.load(path)).to(device)
