"""Autoregressive multi-scale generation across per-scale models, the
``--mode multi_scale_test`` of the JAX `eval/multiscale.py`.

A master config holds one recipe per scale (keys ``scale_*`` or
``config_*``); each scale's model is loaded with its EMA weights, and the
scales, sorted by ``data.image_size``, are chained in one of two coordinate
spaces (``master.coordinate_space``):

* ``haar``: the previous scale's image is the DC band; the scale's model
  samples the detail bands, and the inverse Haar transform gives the next,
  twice larger image;
* ``bicubic``: the previous scale's sample (clipped to [0, 1]) conditions
  the next scale's super-resolution model.

The chain starts from the lowest scale's test ``y``; the GT comes from the
highest scale's test split (haar: ``haar_backward(cat(y, x))``; bicubic:
``x``).  Each batch writes ``pyramid_batch{b}.png`` (every level
nearest-upsampled to the final size, each image min-max scaled, side by
side, with the GT on the right) and the final images
``batch{b}_{i}.png`` under ``{log_path}/multi_scale`` (rounded to 8 bits,
`harness.save_png`; JAX truncates), and the chain's PSNR
and SSIM against the GT (haar: also those of the zero-detail chain) into
``metrics.json`` there, as JAX writes them.  Where `tensorboardX` imports,
the pyramid and each scale's per-band Haar supergrid also go to
TensorBoard under ``{log_path}/autoregressive_samples``, as in JAX.

All draws come from one noise source, by default a `torch.Generator`
seeded with ``master.seed`` (42) on the device, used by the scales'
samplers in turn; a test passes a source that replays the JAX key chain.
The recipes' kernel knobs (``model.fused_tail``, ``model.fused_block``,
``model.conv_dispatch``) are set on each scale's own model when it is
built, so each sampler runs its own scale's choice.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..data.pkl_datasets import PKLDataModule
from ..ops.haar import haar_backward
from ..ops.resize import full_float32
from ..sampling import gaussian_noise
from ..sampling.pc import NoiseSource
from ..training.callbacks import _normalise_per_image, haar_supergrid, image_grid
from ..training.tasks import create_task
from .harness import load_model, save_png
from .metrics import mean_psnr, mean_ssim


def _load_scale(config, device):
    """``(task, model, step)`` of one scale: the recipe's model with the EMA
    weights of ``model.checkpoint_path`` (`harness.load_model`), and its
    task with the sampler's SDE at the checkpoint's step (VS-CMDE's sigma_y
    depends on it)."""
    model, step = load_model(config, device)
    task = create_task(config, model)
    if hasattr(task, "reconfigure"):
        task.reconfigure(int(step))
    return task, model, step


def scale_configs(master_config) -> List:
    """The master config's per-scale recipes, lowest ``data.image_size``
    first."""
    items = vars(master_config)
    keys = sorted(k for k in items if k.startswith(("scale", "config")))
    if not keys:
        keys = sorted(k for k, v in items.items() if hasattr(v, "get") and "training" in v)
    if not keys:
        raise ValueError("master config has no per-scale sub-configs")
    return sorted((items[k] for k in keys), key=lambda c: int(c.data.image_size))


def _nearest_up(x: np.ndarray, factor: int) -> np.ndarray:
    """Nearest-neighbour upsampling of ``[B, H, W, C]`` by an integer factor."""
    return np.repeat(np.repeat(x, factor, axis=1), factor, axis=2)


def rescale_and_concatenate(intermediate_images: List[np.ndarray]) -> np.ndarray:
    """Every pyramid level nearest-upsampled to the last level's size, each
    image min-max scaled, concatenated along the width."""
    max_h = intermediate_images[-1].shape[1]
    upsampled = []
    for image in intermediate_images:
        factor = max_h // image.shape[1]
        if factor > 1:
            image = _nearest_up(image, factor)
        upsampled.append(_normalise_per_image(image.astype(np.float32)))
    return np.concatenate(upsampled, axis=2)


def _writer(log_path: str):
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(os.path.join(log_path, "autoregressive_samples"))


def run_multi_scale_test(
    master_config,
    log_path: str,
    p_steps: int = 2000,
    corrector: str = "conditional_none",
    num_batches: int = 1,
    device: Union[str, torch.device] = "cuda",
    noise: Union[torch.Generator, NoiseSource, None] = None,
    scale_records: Optional[List[Dict]] = None,
) -> List[np.ndarray]:
    """Run the chain over the first ``num_batches`` test batches; returns
    each batch's final-scale images (NHWC numpy).

    ``noise`` replaces the default generator.  Where ``scale_records`` is a
    list, one dict per scale and batch is appended to it: batch, scale,
    image size, seconds of its sampler (host clock, ending in a synchronise
    on the card) and the score evaluations it made.
    """
    device = torch.device(device)
    coord_space = master_config.get("coordinate_space", "haar")
    scales = []
    for config in scale_configs(master_config):
        task, model, _ = _load_scale(config, device)
        scales.append((config, task, model))

    # the chain starts from the lowest scale's test y; the GT is the highest
    # scale's test split
    batches = PKLDataModule(scales[0][0]).test_iterator()
    gt_batches = PKLDataModule(scales[-1][0]).test_iterator()

    out_dir = os.path.join(log_path, "multi_scale")
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    writer = _writer(log_path)
    if noise is None:
        noise = torch.Generator(device=device).manual_seed(int(master_config.get("seed", 42)))
    if isinstance(noise, torch.Generator):
        noise = gaussian_noise(noise)

    results, chain_metrics = [], []
    for batch_idx, (batch, gt_batch) in enumerate(zip(batches, gt_batches)):
        if batch_idx >= num_batches:
            break
        y0 = batch["y"] if isinstance(batch, dict) else batch
        current = torch.from_numpy(y0).to(device)
        pyramid = [np.asarray(y0)]

        for scale_idx, (config, task, model) in enumerate(scales):
            c, h, w = config.data.shape_x
            shape = (current.shape[0], h, w, c)
            fn = task.sampling_fn(shape, p_steps=p_steps, corrector=corrector)
            t0 = time.perf_counter()
            with torch.no_grad(), full_float32():
                samples = fn(noise, model, current)[0] if task.conditional else fn(noise, model)[0]
                if coord_space == "haar":
                    # the samples are the detail bands, current the DC band
                    full = torch.cat([current, samples], dim=-1)
                    current = haar_backward(full)
                else:  # the sample conditions the next scale
                    current = torch.clamp(samples, 0.0, 1.0)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            if coord_space == "haar" and writer is not None:
                grid = haar_supergrid(full.cpu().numpy())
                writer.add_image(f"haar_supergrid_scale_{scale_idx}_batch_{batch_idx}", np.transpose(grid, (2, 0, 1)))
            if scale_records is not None:
                steps = p_steps * (1 + (0 if corrector.endswith("none") else config.sampling.n_steps_each))
                scale_records.append(dict(
                    batch=batch_idx, scale=scale_idx, image_size=int(config.data.image_size),
                    seconds=time.perf_counter() - t0, evaluations=steps,
                ))
            pyramid.append(current.cpu().numpy())

        if isinstance(gt_batch, dict):
            if coord_space == "haar":
                gt = haar_backward(torch.from_numpy(np.concatenate([gt_batch["y"], gt_batch["x"]], axis=-1))).numpy()
            else:
                gt = np.asarray(gt_batch["x"])
        else:
            gt = np.asarray(gt_batch)

        pyr = rescale_and_concatenate(pyramid)
        n = min(pyr.shape[0], gt.shape[0])
        vis = np.concatenate([pyr[:n], _normalise_per_image(gt[:n].astype(np.float32))], axis=2)
        grid = image_grid(vis, nrow=1)
        if writer is not None:
            writer.add_image(f"Autoregressive_Sampling_batch_{batch_idx}", np.transpose(grid, (2, 0, 1)))
        save_png(grid, os.path.join(out_dir, f"pyramid_batch{batch_idx}.png"))

        final = np.clip(pyramid[-1][:n].astype(np.float32), 0.0, 1.0)
        gt_img = np.clip(gt[:n].astype(np.float32), 0.0, 1.0)
        m = {"batch": batch_idx, "n": int(n), "psnr": mean_psnr(final, gt_img), "ssim": mean_ssim(final, gt_img)}
        if coord_space == "haar":
            # the zero-detail control: the same DC band up the chain with
            # every detail band zero (pure math, no sampling)
            dc_only = torch.from_numpy(y0)
            for config, _, _ in scales:
                zeros = torch.zeros(dc_only.shape[:-1] + (config.data.shape_x[0],), dtype=dc_only.dtype)
                dc_only = haar_backward(torch.cat([dc_only, zeros], dim=-1))
            dc_img = np.clip(dc_only.numpy()[:n].astype(np.float32), 0.0, 1.0)
            m["dc_only_psnr"] = mean_psnr(dc_img, gt_img)
            m["dc_only_ssim"] = mean_ssim(dc_img, gt_img)
        chain_metrics.append(m)
        print(f"[multi_scale] batch {batch_idx} chain metrics: {m}", flush=True)

        results.append(pyramid[-1])
        for i in range(pyramid[-1].shape[0]):
            save_png(pyramid[-1][i], os.path.join(out_dir, f"batch{batch_idx}_{i}.png"))
        print(f"[multi_scale] batch {batch_idx}: final {pyramid[-1].shape}", flush=True)

    if chain_metrics:
        summary = {
            "per_batch": chain_metrics,
            "mean_psnr": float(np.mean([m["psnr"] for m in chain_metrics])),
            "mean_ssim": float(np.mean([m["ssim"] for m in chain_metrics])),
            "coordinate_space": coord_space,
            "p_steps": p_steps,
        }
        if all("dc_only_psnr" in m for m in chain_metrics):
            summary["dc_only_mean_psnr"] = float(np.mean([m["dc_only_psnr"] for m in chain_metrics]))
            summary["dc_only_mean_ssim"] = float(np.mean([m["dc_only_ssim"] for m in chain_metrics]))
        with open(os.path.join(out_dir, "metrics.json"), "w") as f:
            json.dump(summary, f, indent=1)
    if writer is not None:
        writer.close()
    return results
