"""The offline evaluation pipeline over saved sample trees (JAX
`eval/pipeline.py:run_evaluation_pipeline`).

Walks ``{base_path}/images/{samples/snr_%.3f/draw_*, x_gt, y_gt}``, aligns
the PNGs by file number, computes PSNR, SSIM and consistency per draw and
the diversity across draws (pixel std of the [0, 1] images), and pickles
``evaluation_info.pkl`` with the JAX package's keys.  LPIPS and FID need
weights that are not in the repo and are not ported (ROADMAP.md section 1,
item 10): they go to ``skipped`` with the JAX package's notes; so does the
image-to-image consistency where cv2 does not import (`metrics.CANNY_NOTE`).
"""

from __future__ import annotations

import os
import pickle
from glob import glob
from typing import Dict, List, Optional, Union

import numpy as np
import torch
from PIL import Image

from ..data.degradations import random_square_mask
from .metrics import FID_NOTE, LPIPS_NOTE, ConsistencyUnavailable, get_consistency_fn, mean_psnr, mean_ssim


def load_images(paths: List[str]) -> np.ndarray:
    """PNG files -> one float32 [0, 1] NHWC RGB batch."""
    return np.stack([np.asarray(Image.open(p).convert("RGB"), dtype=np.float32) / 255.0 for p in paths])


def numbered(d: str) -> Dict[int, str]:
    """``{number: path}`` of the ``<number>.png`` files in ``d``."""
    out = {}
    for p in glob(os.path.join(d, "*.png")):
        stem = os.path.splitext(os.path.basename(p))[0]
        try:
            out[int(stem)] = p
        except ValueError:
            continue
    return out


def run_evaluation_pipeline(
    task: str,
    base_path: str,
    snr: float,
    scale: int = 8,
    mask_coverage: Optional[float] = None,
    device: Union[str, torch.device] = "cuda",
) -> Dict:
    """Evaluate the trees under ``base_path`` at ``snr``; the metrics run on
    ``device``.  For inpainting, ``mask_coverage`` re-rolls each image's
    mask from its number: PNG ``k`` is item ``k - 1`` of the test split,
    whose square the datamodule draws with seed ``k - 1`` (JAX's pipeline
    takes an offset, which its CLI sets to ``first_test_batch *
    batch_size`` and so re-rolls other squares past test batch 0)."""
    samples_root = os.path.join(base_path, "images", "samples", f"snr_{snr:.3f}")
    x_dir = os.path.join(base_path, "images", "x_gt")
    y_dir = os.path.join(base_path, "images", "y_gt")
    draw_dirs = sorted(glob(os.path.join(samples_root, "draw_*")))
    if not draw_dirs:
        raise FileNotFoundError(f"no draws under {samples_root}")

    x_files, y_files = numbered(x_dir), numbered(y_dir)
    draw_files = {d: numbered(d) for d in draw_dirs}
    common = set(x_files) & set(y_files)
    for files in draw_files.values():
        common &= set(files)
    ids = sorted(common)
    if not ids:
        raise FileNotFoundError(f"no images aligned across gt and draws under {base_path}")

    as_tensor = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    x = as_tensor(load_images([x_files[i] for i in ids]))
    draws = {os.path.basename(d): as_tensor(load_images([draw_files[d][i] for i in ids])) for d in draw_dirs}

    results: Dict = {"snr": snr, "n_images": len(ids), "per_draw": {}, "skipped": []}
    consistency_fn = None
    try:
        consistency_fn = get_consistency_fn(task)
    except ConsistencyUnavailable as e:
        results["skipped"].append(f"consistency ({e})")
    except NotImplementedError:
        results["skipped"].append("consistency")

    # inpainting: re-roll the seeded test-time masks from the saved image ids
    masks = None
    if task == "inpainting" and consistency_fn is not None:
        if mask_coverage is None:
            results["skipped"].append("consistency (no mask_coverage/seeds)")
            consistency_fn = None
        else:
            seeds = np.asarray([i - 1 for i in ids])
            masks = as_tensor(random_square_mask(tuple(x.shape), mask_coverage, np.random.default_rng(0), seeds=seeds))
    results["skipped"].append(f"lpips ({LPIPS_NOTE})")

    for name, s in draws.items():
        entry = {"psnr": mean_psnr(s, x), "ssim": mean_ssim(s, x)}
        if consistency_fn is not None:
            if task == "super-resolution":
                entry["consistency"] = float(consistency_fn(s, x, scale))
            elif task == "image-to-image":
                entry["consistency"] = float(consistency_fn(s, x))
            elif task == "inpainting" and masks is not None:
                entry["consistency"] = float(consistency_fn(s, x, masks))
        results["per_draw"][name] = entry

    if len(draws) > 1:
        stack = torch.stack(list(draws.values())).double()
        results["diversity"] = float(torch.std(stack, dim=0, correction=0).mean())
    results["skipped"].append(f"fid ({FID_NOTE})")

    with open(os.path.join(base_path, "evaluation_info.pkl"), "wb") as f:
        pickle.dump(results, f)
    return results
