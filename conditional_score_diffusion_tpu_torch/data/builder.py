"""Offline dataset builders, copied from the JAX package's
`data/builder.py`.

* :func:`create_haar_dataset`: the per-level trees the ``haar_multiscale``
  datamodule reads.  The images of a folder (``*.jpg``, ``*.jpeg``,
  ``*.png``, sorted, the first ``limit``) are split by a permutation of
  ``np.random.default_rng(seed)`` into train, val and test; each, read as
  RGB and resized bicubic by PIL to ``image_size`` where it differs, is
  written under ``{out_base}/{dataset_name}_{image_size}/{phase}/{index}.png``
  (8 bits, truncated), and its Haar approximation band after L
  decompositions (`ops/haar.py`) as ``{dataset_name}_{image_size / 2**L}/
  {phase}/{index}.npy`` (float32 HWC) for L = 1 .. ``max_depth``.  Each
  level's coefficient range is printed and returned.
* :func:`create_ab_paired_dataset`: side-by-side A|B images (edges2shoes)
  split into ``{out_base}/{phase}/{A,B}/`` trees, each half resized
  bicubic by PIL.
* :func:`create_dataset`: the trees a recipe names.

The files, PNG bytes and arrays are those of the JAX functions.
"""

from __future__ import annotations

import glob
import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
from PIL import Image

from ..ops.haar import haar_forward


def _split(n: int, split, seed: int) -> Dict[str, np.ndarray]:
    order = np.random.default_rng(seed).permutation(n)
    n_train, n_val = int(split[0] * n), int(split[1] * n)
    return {"train": order[:n_train], "val": order[n_train : n_train + n_val], "test": order[n_train + n_val :]}


def create_haar_dataset(
    src_dir: str,
    out_base: str,
    dataset_name: str,
    image_size: int,
    max_depth: int = 3,
    split=(0.8, 0.1, 0.1),
    seed: int = 42,
    batch: int = 64,
    limit: Optional[int] = None,
):
    """Write the per-level trees of the images in ``src_dir``; returns
    ``{level: [min, max]}`` of the coefficients."""
    files = sorted(f for f in glob.glob(os.path.join(src_dir, "*")) if f.lower().endswith((".jpg", ".jpeg", ".png")))
    if limit:
        files = files[:limit]
    if not files:
        raise FileNotFoundError(f"no images under {src_dir}")
    ranges = {lvl: [np.inf, -np.inf] for lvl in range(max_depth + 1)}
    for phase, idxs in _split(len(files), split, seed).items():
        dirs = {}
        for lvl in range(max_depth + 1):
            dirs[lvl] = os.path.join(out_base, f"{dataset_name}_{image_size // 2**lvl}", phase)
            Path(dirs[lvl]).mkdir(parents=True, exist_ok=True)
        for start in range(0, len(idxs), batch):
            chunk = idxs[start : start + batch]
            imgs = []
            for j in chunk:
                img = Image.open(files[j]).convert("RGB")
                if img.size != (image_size, image_size):
                    img = img.resize((image_size, image_size), Image.BICUBIC)
                imgs.append(np.asarray(img, np.float32) / 255.0)
            approx = np.stack(imgs)
            for k, j in enumerate(chunk):
                Image.fromarray((approx[k] * 255).astype(np.uint8)).save(os.path.join(dirs[0], f"{j}.png"))
            ranges[0] = [min(ranges[0][0], float(approx.min())), max(ranges[0][1], float(approx.max()))]
            coeffs = torch.from_numpy(approx)
            for lvl in range(1, max_depth + 1):
                coeffs = haar_forward(coeffs)[..., :3]
                arr = coeffs.numpy()
                ranges[lvl] = [min(ranges[lvl][0], float(arr.min())), max(ranges[lvl][1], float(arr.max()))]
                for k, j in enumerate(chunk):
                    np.save(os.path.join(dirs[lvl], f"{j}.npy"), arr[k])
    for lvl, (lo, hi) in ranges.items():
        print(f"[haar builder] level {lvl}: coefficient range [{lo:.4f}, {hi:.4f}]")
    return ranges


def create_ab_paired_dataset(
    master_path: str,
    out_base: str,
    resize_size: int = 64,
    split=(0.8, 0.1, 0.1),
    seed: int = 42,
    limit: Optional[int] = None,
):
    """Split the side-by-side ``*.jpg`` A|B images of ``master_path`` into
    A and B trees under ``out_base``."""
    files = sorted(glob.glob(os.path.join(master_path, "*.jpg")))
    if limit:
        files = files[:limit]
    if not files:
        raise FileNotFoundError(f"no AB images under {master_path}")
    for phase, idxs in _split(len(files), split, seed).items():
        a_dir, b_dir = os.path.join(out_base, phase, "A"), os.path.join(out_base, phase, "B")
        Path(a_dir).mkdir(parents=True, exist_ok=True)
        Path(b_dir).mkdir(parents=True, exist_ok=True)
        for j in idxs:
            ab = Image.open(files[j]).convert("RGB")
            w, h = ab.size
            a, b = ab.crop((0, 0, w // 2, h)), ab.crop((w // 2, 0, w, h))
            if resize_size:
                a = a.resize((resize_size, resize_size), Image.BICUBIC)
                b = b.resize((resize_size, resize_size), Image.BICUBIC)
            name = os.path.basename(files[j])
            a.save(os.path.join(a_dir, name))
            b.save(os.path.join(b_dir, name))
    print(f"[ab builder] wrote paired trees under {out_base}")


def create_dataset(config):
    """The trees ``config`` names: the Haar trees for a Haar datamodule or
    the ``multi_scale`` task, the A/B trees for ``image-to-image``."""
    data = config.data
    task = data.get("task", "")
    if "haar" in data.get("datamodule", "") or task == "multi_scale":
        return create_haar_dataset(
            src_dir=os.path.join(data.base_dir, data.dataset),
            out_base=data.base_dir,
            dataset_name=data.dataset,
            image_size=data.target_resolution,
            max_depth=data.get("max_haar_depth", 3),
            split=tuple(data.split),
            seed=config.seed,
        )
    if task == "image-to-image":
        return create_ab_paired_dataset(
            master_path=os.path.join(data.base_dir, data.dataset + "_AB"),
            out_base=os.path.join(data.base_dir, data.dataset),
            resize_size=data.image_size,
            split=tuple(data.split),
            seed=config.seed,
        )
    raise NotImplementedError(f"no dataset builder for task {task!r}")
