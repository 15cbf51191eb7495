"""The paper's other inverse problems, copied from the JAX package's
`configs/inverse_problems.py`: inpainting and colorization on celebA-HQ-160
at 128px (`General_PKLDataset`), image-to-image translation on edges2shoes
at 64px (``paired``), each for the estimators ``ours_NDV`` (CMDE),
``ours_DV`` (VS-CMDE), ``song`` (CDiffE) and ``sr3`` (CDE); the two
sigma_max_y sweeps (`i2i_interpolation_config`,
`inpainting_interpolation_config`).

:data:`RECIPES` maps the path of every recipe file of the JAX tree under
``configs/ve/inverse_problems/{inpainting, colorization,
image_to_image_translation, MRI_to_PET}`` (without ``.py``, from
``configs/``) to the call that builds it, master configs included, so that
``--config configs/ve/inverse_problems/inpainting/celebA_ours_NDV.py``
names the same recipe in the port's CLI as in JAX's (`main.load_config`).

The texture twins run those recipes at their own widths on data in the
repo, with only the data and the test range changed (test batch 0):

* `texture160_inpainting_cmde_config` (``_block``: kernels 1-3 on) and
  `texture160_colorization_cmde_block_config`: the texture160 GT images,
  resized to 128 by the datamodule, with the known-region ``consistency``
  added to the metrics;
* `texture64_i2i_cmde_block_config`: a ``paired`` tree of texture64 test
  images (B, PNG) and their 4x SR degradation (A), the edges2shoes shapes;
* `texture_mri_to_pet_slices_block_config` and
  `texture_mri_to_pet_3d_config`: ``.npy`` trees of the texture160 train
  images' luma resized to 96 in [0, 255] (B) and its 4x SR degradation
  (A), 2-D slices or volumes of 16 consecutive slices.

The twins' trees are written by `write_texture64_paired` and
`write_texture_mri_to_pet` (under ``logs/texture_inverse`` unless told
otherwise); a recipe only points at them.
"""

from __future__ import annotations

import os
from typing import Callable, Dict

import numpy as np

from .base import Config, base_config
from .celeba_sr import _root_numel
from .extra import mri_to_pet_config

_TASK_DEFAULTS = {
    "inpainting": dict(
        dataset="celebA-HQ-160", datamodule="General_PKLDataset", image_size=128,
        nf=96, ch_mult=(1, 1, 2, 2, 3, 3), attn=(16, 8, 4),
        sigma_max_y_ndv=1.0, batch=25, eval_batch=25,
        metrics=["lpips", "psnr", "ssim", "diversity"], use_seed=True,
    ),
    "colorization": dict(
        dataset="celebA-HQ-160", datamodule="General_PKLDataset", image_size=128,
        nf=96, ch_mult=(1, 1, 2, 2, 3, 3), attn=(16, 8, 4),
        sigma_max_y_ndv=0.1, batch=25, eval_batch=25,
        metrics=["lpips", "psnr", "ssim", "diversity"], use_seed=False,
    ),
    "image-to-image": dict(
        dataset="edges2shoes", datamodule="paired", image_size=64,
        nf=128, ch_mult=(1, 1, 2, 2), attn=(16, 8),
        sigma_max_y_ndv=1.0, batch=50, eval_batch=50,
        metrics=["lpips", "psnr", "ssim", "diversity"], use_seed=False,
    ),
}
APPROACHES = ("ours_NDV", "ours_DV", "song", "sr3")


def inverse_problem_config(task: str, approach: str) -> Config:
    """``task`` inpainting, colorization or image-to-image; ``approach`` one
    of :data:`APPROACHES`."""
    if task not in _TASK_DEFAULTS:
        raise KeyError(
            f"task {task!r} not in {sorted(_TASK_DEFAULTS)}; for super-resolution "
            "use configs.celeba_sr.celeba_sr_160_config"
        )
    d = _TASK_DEFAULTS[task]
    config = base_config()

    training = config.training
    training.lightning_module = "conditional_decreasing_variance" if approach == "ours_DV" else "conditional"
    training.conditioning_approach = "Song" if approach == "song" else approach
    training.batch_size = d["batch"]
    training.n_iters = 250000 if task == "colorization" else 500000
    training.visualization_callback = "paired"
    training.likelihood_weighting = True
    training.continuous = True
    training.reduce_mean = True
    training.sde = "vesde"

    sampling = config.sampling
    sampling.predictor = "conditional_reverse_diffusion"
    sampling.corrector = "conditional_langevin"
    sampling.snr = 0.15

    evaluate = config.eval
    evaluate.callback = "test_paired"
    evaluate.evaluation_metrics = list(d["metrics"])
    evaluate.batch_size = d["eval_batch"]
    evaluate.snr = [0.15]
    evaluate.draws = [2, 3, 4, 5]
    if task == "image-to-image":
        evaluate.first_test_batch = 0
        evaluate.last_test_batch = 50
    else:
        evaluate.first_test_batch = 50
        evaluate.last_test_batch = 100
    evaluate.use_seed = d["use_seed"]

    data = config.data
    data.dataset = d["dataset"]
    data.task = task
    data.scale = 8
    data.mask_coverage = 0.25
    data.datamodule = d["datamodule"]
    size = d["image_size"]
    data.target_resolution = size
    data.image_size = size
    data.effective_image_size = size
    ych = 1 if task == "colorization" else 3
    data.shape_x = [3, size, size]
    data.shape_y = [ych, size, size]
    data.use_flip = True
    data.use_crop = False
    data.use_rot = False
    data.upscale_lr = False
    data.num_channels = 3 + ych

    model = config.model
    model.num_scales = 1000
    model.sigma_max_x = _root_numel(data.shape_x)
    model.sigma_min_x = 5e-3
    model.sigma_min_y = 5e-3
    model.sigma_min_y_target = 5e-3
    if approach == "song":
        model.sigma_max_y = model.sigma_max_x
    elif approach in ("ours_DV", "sr3"):
        # the anneal's target is the task's CMDE sigma_max_y; image-to-image
        # VS-CMDE anneals over 300k steps
        model.sigma_max_y = _root_numel(data.shape_y)
        model.sigma_max_y_target = d["sigma_max_y_ndv"]
        if approach == "ours_DV" and task == "image-to-image":
            model.reach_target_steps = 300000
        else:
            model.reach_target_steps = training.n_iters
        if approach == "sr3":
            model.sigma_min = model.sigma_min_x
            model.sigma_max = model.sigma_max_x
    else:
        model.sigma_max_y = d["sigma_max_y_ndv"]

    model.dropout = 0.1
    model.embedding_type = "positional"
    model.name = "ddpm_paired_SR3" if approach == "sr3" else "ddpm_paired"
    model.ema_rate = 0.999
    model.nf = d["nf"]
    model.ch_mult = tuple(d["ch_mult"])
    model.num_res_blocks = 2
    model.attn_resolutions = tuple(d["attn"])
    model.resamp_with_conv = True
    model.conditional = True
    model.fir = True
    model.fir_kernel = [1, 3, 3, 1]
    model.skip_rescale = True
    model.resblock_type = "biggan"
    model.progressive = "output_skip"
    model.progressive_input = "input_skip"
    model.progressive_combine = "sum"
    model.attention_type = "ddpm"
    model.init_scale = 0.0
    model.fourier_scale = 16
    model.conv_size = 3
    model.input_channels = data.num_channels
    model.output_channels = 3 if approach == "sr3" else data.num_channels

    config.optim.lr = 2e-4
    config.optim.warmup = 2500
    config.optim.grad_clip = 1.0
    return config


def i2i_interpolation_config(k: int = None, *, sr3: bool = False) -> Config:
    """The edges2shoes sigma_max_y sweep: point ``k`` (1-9) sets sigma_max_y
    = 10^((k - 5) / 2); ``sr3`` the CDE baseline."""
    config = inverse_problem_config("image-to-image", "sr3" if sr3 else "ours_NDV")
    config.training.batch_size = 80
    config.eval.draws = [1]
    config.eval.first_test_batch = 0
    config.eval.last_test_batch = 100

    model = config.model
    model.nf = 96
    model.ch_mult = (1, 1, 2, 2, 3)
    model.attn_resolutions = (16, 8, 4)
    if sr3:
        model.sigma_max_y_target = 0.1
        model.reach_target_steps = 500000
    else:
        config.training.conditioning_approach = f"ours_NDV_{k}"
        model.sigma_max_y = float(10.0 ** ((k - 5) / 2.0))
    return config


# the inpainting sweep's sigma_max_y at points c1 .. c10
INPAINTING_SWEEP = [5.1e-3, 1.671e-2, 5.474e-2, 1.793e-1, 5.875e-1, 1.925, 6.305, 2.066e1, 6.767e1, 2.217e2]


def inpainting_interpolation_config(k: int) -> Config:
    """The inpainting sigma_max_y sweep at point c``k``, ``k`` in 1..10."""
    config = inverse_problem_config("inpainting", "ours_NDV")
    training = config.training
    training.conditioning_approach = str(k)
    training.batch_size = 100
    training.n_iters = 356999

    evaluate = config.eval
    evaluate.draws = [1]
    evaluate.first_test_batch = 0
    evaluate.last_test_batch = 25
    evaluate.batch_size = training.batch_size

    config.model.sigma_max_y = INPAINTING_SWEEP[k - 1]
    return config


def _smaxy_1(task: str, n_iters: int = None) -> Config:
    """The CMDE recipe with sigma_max_y = 1 (and, for inpainting, 250k steps)."""
    config = inverse_problem_config(task, "ours_NDV")
    if n_iters is not None:
        config.training.n_iters = n_iters
    config.model.sigma_max_y = 1
    return config


# the file stem of each estimator in the JAX tree
_STEMS = {"ours_NDV": "ours_NDV", "ours_DV": "ours_DV", "song": "song", "sr3": "SR3"}
_TREE = "ve/inverse_problems"


def _estimators_master(task: str) -> Config:
    return Config(**{stem: inverse_problem_config(task, approach) for approach, stem in _STEMS.items()})


def _recipes() -> Dict[str, Callable[[], Config]]:
    table = {}
    for task, folder, prefix in (
        ("inpainting", "inpainting", "celebA"),
        ("colorization", "colorization", "celebA"),
        ("image-to-image", "image_to_image_translation", "edges2shoes"),
    ):
        for approach, stem in _STEMS.items():
            table[f"{_TREE}/{folder}/{prefix}_{stem}"] = lambda t=task, a=approach: inverse_problem_config(t, a)
    table[f"{_TREE}/inpainting/celebA_ours_NDV_smaxy_1"] = lambda: _smaxy_1("inpainting", n_iters=250000)
    table[f"{_TREE}/colorization/celebA_ours_NDV_smaxy_1"] = lambda: _smaxy_1("colorization")
    table[f"{_TREE}/inpainting/master_config"] = lambda: _estimators_master("inpainting")
    table[f"{_TREE}/image_to_image_translation/master_config"] = lambda: _estimators_master("image-to-image")
    i2i_sweep = f"{_TREE}/image_to_image_translation/interpolation"
    for k in range(1, 10):
        table[f"{i2i_sweep}/ours_NDV_{k}"] = lambda k=k: i2i_interpolation_config(k)
    table[f"{i2i_sweep}/SR3"] = lambda: i2i_interpolation_config(sr3=True)
    table[f"{i2i_sweep}/master_config"] = lambda: Config(
        **{f"ours_DV_{k}": i2i_interpolation_config(k) for k in range(1, 10)}, SR3=i2i_interpolation_config(sr3=True)
    )
    for k in range(1, 11):
        table[f"{_TREE}/inpainting/interpolation/c{k}"] = lambda k=k: inpainting_interpolation_config(k)
    table[f"{_TREE}/inpainting/interpolation/master_config"] = lambda: Config(
        **{f"c{k}": inpainting_interpolation_config(k) for k in range(1, 11)}
    )
    table[f"{_TREE}/MRI_to_PET/MRI_to_PET_slices"] = lambda: mri_to_pet_config(volumetric=False)
    table[f"{_TREE}/MRI_to_PET/MRI_to_PET_slices3D"] = lambda: mri_to_pet_config(volumetric=True)
    table[f"{_TREE}/MRI_to_PET/mri_to_pet_SR3"] = lambda: mri_to_pet_config(volumetric=False, approach="sr3")
    return table


#: recipe file path (from ``configs/``, without ``.py``) -> the call that builds it
RECIPES = _recipes()


def path_key(name: str) -> str:
    """A recipe file's path (``configs/ve/ncsnv2/celeba.py``) as a table
    key (``ve/ncsnv2/celeba``); a key stays as it is."""
    key = os.path.normpath(name).replace(os.sep, "/")
    key = key[: -len(".py")] if key.endswith(".py") else key
    return key[len("configs/") :] if key.startswith("configs/") else key


def recipe_key(name: str):
    """The :data:`RECIPES` key ``name`` names (a key, or a path to its file
    such as ``configs/ve/inverse_problems/inpainting/celebA_ours_NDV.py``),
    else None."""
    key = path_key(name)
    return key if key in RECIPES else None


# ---- the texture twins ------------------------------------------------------

TWIN_DIR = os.path.join("logs", "texture_inverse")
I2I_DATASET, MRI_DATASET, MRI3D_DATASET = "texture64_i2i", "texture_mri_to_pet", "texture_mri_to_pet_3d"
# items of each split of the written trees: (train, val, test); volumes for 3-D
I2I_SPLITS, MRI_SPLITS, MRI3D_SPLITS = (235, 50, 50), (128, 64, 64), (8, 2, 2)
VOLUME_DEPTH = 16


def _twin(config: Config, dataset: str, base_dir: str, block: bool) -> Config:
    config.data.dataset = dataset
    config.data.base_dir = base_dir
    config.eval.first_test_batch = 0
    config.eval.last_test_batch = 1
    if block:
        config.model.fused_tail = True
        config.model.fused_block = True
    return config


def _with_consistency(config: Config) -> Config:
    config.eval.evaluation_metrics.append("consistency")
    return config


def texture160_inpainting_cmde_config(block: bool = False, base_dir: str = "datasets") -> Config:
    """Inpainting CMDE on the texture160 GT images (resized to 128), test
    batch 0, the known-region consistency measured (``block``: kernels 1-3
    on)."""
    return _with_consistency(_twin(inverse_problem_config("inpainting", "ours_NDV"), "texture160", base_dir, block))


def texture160_inpainting_cmde_block_config(base_dir: str = "datasets") -> Config:
    return texture160_inpainting_cmde_config(block=True, base_dir=base_dir)


def texture160_colorization_cmde_block_config(base_dir: str = "datasets") -> Config:
    """Colorization CMDE on the texture160 GT images, as the inpainting twin,
    kernels 1-3 on."""
    return _with_consistency(_twin(inverse_problem_config("colorization", "ours_NDV"), "texture160", base_dir, True))


def texture64_i2i_cmde_block_config(base_dir: str = TWIN_DIR) -> Config:
    """Image-to-image CMDE (the edges2shoes recipe) on the tree of
    `write_texture64_paired` under ``base_dir``, kernels 1-3 on."""
    config = inverse_problem_config("image-to-image", "ours_NDV")
    return _with_consistency(_twin(config, I2I_DATASET, base_dir, True))


def texture_mri_to_pet_slices_block_config(base_dir: str = TWIN_DIR) -> Config:
    """MRI->PET slices (VS-CMDE) on the 2-D tree of
    `write_texture_mri_to_pet` under ``base_dir``, kernels 1-3 on."""
    return _twin(mri_to_pet_config(volumetric=False), MRI_DATASET, base_dir, True)


def texture_mri_to_pet_3d_config(base_dir: str = TWIN_DIR) -> Config:
    """MRI->PET volumes (VS-CMDE, ``ddpm3D_paired``) on the 3-D tree of
    `write_texture_mri_to_pet` under ``base_dir``."""
    return _twin(mri_to_pet_config(volumetric=True), MRI3D_DATASET, base_dir, False)


def _split_dirs(root: str, phase: str):
    dirs = tuple(os.path.join(root, phase, k) for k in ("A", "B"))
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    return dirs


def write_texture64_paired(base_dir: str = TWIN_DIR, source_dir: str = "datasets", splits=I2I_SPLITS) -> str:
    """``{base_dir}/texture64_i2i/{train,val,test}/{A,B}/{i:04d}.png``: B the
    texture64 test images in order, split ``splits``, A each one's 4x SR
    degradation (bicubic down, nearest up) in 8 bits.  Returns
    ``base_dir``."""
    from PIL import Image

    from ..data.degradations import sr_degrade
    from ..data.pkl_datasets import load_pkl_images

    images = load_pkl_images(os.path.join(source_dir, "texture64", "texture64-test.pklv4"))
    start = 0
    for phase, n in zip(("train", "val", "test"), splits):
        a_dir, b_dir = _split_dirs(os.path.join(base_dir, I2I_DATASET), phase)
        gt = np.stack(images[start : start + n])
        lq = sr_degrade(gt.astype(np.float32) / 255.0, 4)
        for i in range(n):
            Image.fromarray(gt[i]).save(os.path.join(b_dir, f"{i:04d}.png"))
            Image.fromarray(np.clip(lq[i] * 255.0 + 0.5, 0, 255).astype(np.uint8)).save(
                os.path.join(a_dir, f"{i:04d}.png")
            )
        start += n
    return base_dir


def mri_slices(images) -> np.ndarray:
    """uint8 RGB images -> their luma resized bicubic to 96, [N, 96, 96],
    float32, clipped to [0, 255] (the recipe's ``range_x``)."""
    from ..data.degradations import bicubic_resize_np, grayscale

    luma = grayscale(np.stack(images).astype(np.float32) / 255.0)
    return np.clip(bicubic_resize_np(luma, 96)[..., 0] * 255.0, 0.0, 255.0)


def write_texture_mri_to_pet(
    base_dir: str = TWIN_DIR, source_dir: str = "datasets", volumetric: bool = False, splits=None
) -> str:
    """``{base_dir}/texture_mri_to_pet{,_3d}/{train,val,test}/{A,B}/{i:04d}.npy``
    from the texture160 train images in order: B a slice (`mri_slices`),
    A its 4x SR degradation; with ``volumetric``, [96, 96, 16] volumes of
    16 consecutive slices (taken after the 2-D tree's).  ``splits``: items
    (volumes) per split.  Returns ``base_dir``."""
    from ..data.degradations import sr_degrade
    from ..data.pkl_datasets import load_pkl_images

    splits = splits or (MRI3D_SPLITS if volumetric else MRI_SPLITS)
    depth = VOLUME_DEPTH if volumetric else 1
    images = load_pkl_images(os.path.join(source_dir, "texture160", "texture160-train.pklv4"))
    start = sum(MRI_SPLITS) if volumetric else 0
    root = os.path.join(base_dir, MRI3D_DATASET if volumetric else MRI_DATASET)
    for phase, n in zip(("train", "val", "test"), splits):
        a_dir, b_dir = _split_dirs(root, phase)
        b = mri_slices(images[start : start + n * depth])
        a = sr_degrade(b[..., None], 4)[..., 0]
        for i in range(n):
            vb, va = b[i * depth : (i + 1) * depth], a[i * depth : (i + 1) * depth]
            if volumetric:
                vb, va = np.moveaxis(vb, 0, -1), np.moveaxis(va, 0, -1)
            else:
                vb, va = vb[0], va[0]
            np.save(os.path.join(b_dir, f"{i:04d}.npy"), np.ascontiguousarray(vb, dtype=np.float32))
            np.save(os.path.join(a_dir, f"{i:04d}.npy"), np.ascontiguousarray(va, dtype=np.float32))
        start += n * depth
    return base_dir
