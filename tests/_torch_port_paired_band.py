"""The band that `chip_smoke.py` holds the port's full-length ``paired``
callback in, from the JAX callback on the trained texture64 checkpoint.

    JAX_PLATFORMS=cpu python tests/_torch_port_paired_band.py [--seeds 1 2 3]

Restores the checkpoint as `tests/_torch_port_convert_texture64.py` does and
fires the JAX `training/callbacks.py` ``paired`` callback of the
`configs/artifacts/texture64_sr_cmde.py` recipe (1000 steps, the recipe's
sampler) on a stub trainer whose writer keeps the grid and whose
``val_iterator`` gives the texture64 test split (the split the port's
recipe reads on the card, ``eval.loss_split = "test"``): its first 8
images.  The callback samples with ``jax.random.key(step)``; each seed is
one step.  From each grid (rows y | sample | ground truth) the PSNR of the
sample column against the ground-truth column, per image, averaged.
Prints one JSON line per seed and the band: the range over the seeds
widened by half its width on each side, and at least the harness's
+-0.5 dB around the mean (`PERF.md` section 2).  Minutes a seed on a CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import jax  # noqa: E402
import numpy as np  # noqa: E402

N_IMAGES = 8
HARNESS_PSNR_BAND = 0.5


def grid_psnr(grid_chw: np.ndarray, size: int) -> float:
    """Mean PSNR (range 1) of the sample column against the ground-truth
    column of a ``paired`` grid (rows of y | sample | ground truth)."""
    grid = np.transpose(grid_chw, (1, 2, 0)).astype(np.float64)
    out = []
    for r in range(grid.shape[0] // size):
        row = grid[r * size : (r + 1) * size]
        sample, gt = row[:, size : 2 * size], row[:, 2 * size : 3 * size]
        out.append(20 * np.log10(1.0 / np.sqrt(np.mean((sample - gt) ** 2))))
    return float(np.mean(out))


def band(values):
    lo, hi = min(values), max(values)
    mean = float(np.mean(values))
    w = hi - lo
    return min(lo - w / 2, mean - HARNESS_PSNR_BAND), max(hi + w / 2, mean + HARNESS_PSNR_BAND)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    from _torch_port_convert_texture64 import restore_jax_state
    from configs.artifacts.texture64_sr_cmde import get_config
    from conditional_score_diffusion_tpu.data import create_datamodule
    from conditional_score_diffusion_tpu.models import init_model
    from conditional_score_diffusion_tpu.training import callbacks

    config = get_config()
    module, _ = init_model(config, jax.random.key(config.seed))
    state = restore_jax_state()
    dm = create_datamodule(config)
    dm.setup()
    grids = {}
    writer = types.SimpleNamespace(add_image=lambda tag, img, step: grids.__setitem__(step, np.asarray(img)))
    trainer = types.SimpleNamespace(
        module=module, state=state, writer=writer,
        datamodule=types.SimpleNamespace(val_iterator=lambda batch_size=None: dm.test_iterator(batch_size)),
    )
    fn = callbacks.get_callback("paired")(config, "train").fn
    psnrs = []
    for seed in args.seeds:
        fn(trainer, seed)
        psnrs.append(grid_psnr(grids[seed], config.data.image_size))
        print(json.dumps({"seed": seed, "images": N_IMAGES, "psnr": psnrs[-1]}), flush=True)
    print(json.dumps({"band": {"psnr": band(psnrs)}, "mean": float(np.mean(psnrs))}))


if __name__ == "__main__":
    main()
