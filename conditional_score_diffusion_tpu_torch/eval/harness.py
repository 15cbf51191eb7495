"""The --mode test harness: sample the test split, save PNG trees, compute
metrics (JAX `eval/harness.py:run_test`).

For each test batch in ``[eval.first_test_batch, eval.last_test_batch)``,
each snr in ``eval.snr`` and each draw in ``eval.draws``: run the
conditional PC sampler (`sampling/pc.py:get_conditional_sampling_fn`) with
the EMA weights, clamp to [0, 1], save PNGs under
``{eval.base_log_dir}/{task}/{dataset}/{approach}/images/{samples,x_gt,y_gt}``
(samples further under ``snr_%.3f/draw_%d``, files numbered from 1 across
the split), and compute PSNR, SSIM and consistency per draw, then their mean
over the draws and the diversity of the stacked draws x 255 per batch; the
lists, one value per batch, are pickled to
``test_metrics/{first}_{last}.pkl`` as JAX writes them, with the bits/dim
of `eval/bpd.py` under ``"bpd"`` where ``eval.enable_bpd`` is set and the
recipe names no ``training.conditioning_approach``.  LPIPS of each draw
against the ground truth (`eval/lpips.py`) joins the metrics where
``eval.evaluation_metrics`` names it and its weights load; where they do
not, it is skipped with the JAX package's message.  The batches are the recipe's datamodule's
test split; an inpainting batch's ``mask`` feeds its consistency.

All draws come from one noise source, by default a `torch.Generator` seeded
with ``config.seed + 17`` on the device, used by the sampler calls in turn
in the JAX order of use; a test passes a source that replays the JAX key
chain.  The sampler runs in the recipe's precision (float32) with TF32 off.
"""

from __future__ import annotations

import os
import pickle
import time
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch
from PIL import Image

from ..data import create_datamodule
from ..models import create_model
from ..ops.resize import full_float32
from ..sampling import gaussian_noise, get_conditional_sampling_fn
from ..sampling.pc import NoiseSource
from ..sde import build_sde
from ..training.checkpoint import load_eval_weights
from ..training.schedules import is_decreasing_variance, sigma_y_at_step
from .bpd import evaluate_bpd
from .lpips import load_lpips
from .metrics import ConsistencyUnavailable, get_consistency_fn, mean_psnr, mean_ssim
from .metrics import diversity as diversity_metric


def save_png(img01: np.ndarray, path: str) -> None:
    """An HWC [0, 1] image as an 8-bit PNG, each value rounded to the
    nearest level (the JAX harness truncates, which leaves its trees half a
    level low on average)."""
    arr = np.clip(np.asarray(img01, dtype=np.float32) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    Image.fromarray(arr).save(path)


def output_dir(config) -> str:
    """``{eval.base_log_dir}/{task}/{dataset}/{approach}``: where the PNG
    trees, ``test_metrics/`` and the pipeline's ``evaluation_info.pkl`` go."""
    approach = config.training.get("conditioning_approach", "unconditional")
    return os.path.join(config.eval.base_log_dir, config.data.task, config.data.dataset, approach)


def load_model(config, device, checkpoint_path: Optional[str] = None):
    """``(model, step)``: the recipe's model with the EMA weights of
    ``checkpoint_path`` (or ``model.checkpoint_path``), an EMA-only file or
    a directory of train checkpoints; without either, the fresh model at
    step 0, as JAX then evaluates its init."""
    model = create_model(config, device)
    path = checkpoint_path or config.model.get("checkpoint_path", "")
    if not path or not os.path.exists(path):
        return model, 0
    step, weights = load_eval_weights(path)
    model.load_state_dict(weights, strict=True)
    return model, step


def run_test(
    config,
    log_path: str = "",
    checkpoint_path: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
    noise: Union[torch.Generator, NoiseSource, None] = None,
    draw_records: Optional[List[Dict]] = None,
) -> Dict:
    """Run the harness; returns the pickled dict ``{snr: {metric: [one
    value per batch]}}``.

    ``log_path`` is unused, as in JAX (the trees go under
    ``eval.base_log_dir``).  ``noise`` replaces the default generator.
    Where ``draw_records`` is a list, one dict per sampler call is appended
    to it: batch, snr, draw, seconds (host clock, ending in a synchronise on
    the card) and that draw's metrics.
    """
    del log_path
    device = torch.device(device)
    evalc = config.eval
    base = output_dir(config)
    samples_dir = os.path.join(base, "images", "samples")
    gt_x_dir = os.path.join(base, "images", "x_gt")
    gt_y_dir = os.path.join(base, "images", "y_gt")
    for d in (samples_dir, gt_x_dir, gt_y_dir):
        Path(d).mkdir(parents=True, exist_ok=True)

    model, step = load_model(config, device, checkpoint_path)
    # VS-CMDE: sigma_y as the schedule leaves it at the checkpointed step
    if is_decreasing_variance(config):
        sde, eps = build_sde(config, *sigma_y_at_step(config, step))
    else:
        sde, eps = build_sde(config)

    snr_list = evalc.snr if isinstance(evalc.snr, list) else [evalc.snr]
    draws = list(evalc.draws)
    metrics_list = list(evalc.evaluation_metrics)
    if "diversity" in metrics_list and len(draws) == 1:
        metrics_list.remove("diversity")
    lpips = None
    if "lpips" in metrics_list:
        try:
            lpips = load_lpips(device=device)
        except FileNotFoundError as e:
            print(f"[test] LPIPS unavailable ({e}); skipping lpips metric.")
            metrics_list.remove("lpips")

    shape_x = tuple(config.data.shape_x)
    sample_shape = (evalc.batch_size,) + shape_x[1:] + (shape_x[0],)

    consistency_fn = None
    if "consistency" in metrics_list:
        try:
            consistency_fn = get_consistency_fn(config.data.task)
        except NotImplementedError as e:
            if isinstance(e, ConsistencyUnavailable):
                print(f"[test] consistency unavailable ({e}); skipping it.")
            metrics_list.remove("consistency")

    results = {e_snr: {m: [] for m in metrics_list} for e_snr in snr_list}
    samplers = {}
    for e_snr in snr_list:
        samplers[e_snr] = get_conditional_sampling_fn(
            config, sde, sample_shape, eps,
            predictor=evalc.predictor, corrector=evalc.corrector,
            p_steps=evalc.p_steps, c_steps=evalc.c_steps, snr=e_snr,
            denoise=evalc.denoise, use_path=evalc.get("use_path", "default"),
        )
        for draw in draws:
            Path(os.path.join(samples_dir, f"snr_{e_snr:.3f}", f"draw_{draw}")).mkdir(parents=True, exist_ok=True)

    if noise is None:
        noise = torch.Generator(device=device).manual_seed(config.seed + 17)
    if isinstance(noise, torch.Generator):
        noise = gaussian_noise(noise)
    images_tested = evalc.batch_size * evalc.first_test_batch

    datamodule = create_datamodule(config)
    datamodule.setup()
    for batch_idx, batch in enumerate(datamodule.test_iterator()):
        if batch_idx < evalc.first_test_batch:
            continue
        if batch_idx >= evalc.last_test_batch:
            break
        x_gt = torch.from_numpy(batch["x"]).to(device)
        y = torch.from_numpy(batch["y"]).to(device)

        if evalc.save_samples:
            for i in range(x_gt.shape[0]):
                save_png(batch["x"][i], os.path.join(gt_x_dir, f"{images_tested + i + 1}.png"))
                save_png(batch["y"][i], os.path.join(gt_y_dir, f"{images_tested + i + 1}.png"))

        for e_snr in snr_list:
            per_draw = {m: [] for m in metrics_list}
            draw_stack = []
            for draw in draws:
                t0 = time.perf_counter()
                with torch.no_grad(), full_float32():
                    samples = samplers[e_snr](noise, model, y)[0]
                samples = torch.clamp(samples, 0.0, 1.0)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                seconds = time.perf_counter() - t0

                if evalc.save_samples:
                    ddir = os.path.join(samples_dir, f"snr_{e_snr:.3f}", f"draw_{draw}")
                    host = samples.cpu().numpy()
                    for i in range(host.shape[0]):
                        save_png(host[i], os.path.join(ddir, f"{images_tested + i + 1}.png"))

                if "lpips" in metrics_list:
                    with torch.no_grad(), full_float32():
                        per_draw["lpips"].append(float(lpips(x_gt, samples).mean()))
                if "psnr" in metrics_list:
                    per_draw["psnr"].append(mean_psnr(samples, x_gt))
                if "ssim" in metrics_list:
                    per_draw["ssim"].append(mean_ssim(samples, x_gt))
                if "consistency" in metrics_list:
                    if config.data.task == "super-resolution":
                        per_draw["consistency"].append(consistency_fn(samples, x_gt, config.data.scale))
                    elif config.data.task == "inpainting" and "mask" in batch:
                        mask = torch.from_numpy(batch["mask"]).to(device)
                        per_draw["consistency"].append(consistency_fn(samples, x_gt, mask))
                    else:
                        per_draw["consistency"].append(consistency_fn(samples, x_gt))
                if "diversity" in metrics_list:
                    draw_stack.append(samples)
                if draw_records is not None:
                    draw_records.append(dict(
                        batch=batch_idx, snr=e_snr, draw=draw, seconds=seconds,
                        **{m: v[-1] for m, v in per_draw.items() if v},
                    ))

            for m in metrics_list:
                if m == "diversity":
                    results[e_snr][m].append(diversity_metric(torch.stack(draw_stack) * 255.0))
                else:
                    results[e_snr][m].append(float(np.mean(per_draw[m])))

        images_tested += x_gt.shape[0]
        print(f"[test] batch {batch_idx} done ({images_tested} images)", flush=True)

    # bits/dim over the recipe's split, for an unconditional model (JAX's condition)
    if evalc.get("enable_bpd", False) and "conditioning_approach" not in config.training:
        with full_float32():
            results["bpd"] = evaluate_bpd(config, model, create_datamodule(config), device=device)

    metrics_dir = os.path.join(base, "test_metrics")
    Path(metrics_dir).mkdir(parents=True, exist_ok=True)
    out_file = os.path.join(metrics_dir, f"{evalc.first_test_batch}_{evalc.last_test_batch}.pkl")
    with open(out_file, "wb") as f:
        pickle.dump(results, f)

    for e_snr in snr_list:
        for m in metrics_list:
            vals = results[e_snr][m]
            if vals:
                print(f"snr: {e_snr:.3f} - eval metric: {m} --- mean value: {np.mean(vals):.5f}")
    return results
