"""Master configs of ``--mode multi_scale_test`` (`eval/multiscale.py`): a
`Config` of per-scale recipes (keys ``scale_*`` / ``config_*``) and the
``coordinate_space`` that chains them.

* The trained texture64 Haar pyramid, copied from the JAX package's
  `configs/artifacts/texture64_haar_scales.py` and
  `texture64_multiscale_master.py`: two VS-CMDE detail-prediction scales
  (16px DC -> 32px -> 64px), ``ddpm_paired`` nf=48.  The weights are the
  orbax checkpoints' EMA converted to torch files in this package
  (`assets/texture64_pyramid_scale{32,64}_ema.pt`, written by
  `tests/_torch_port_convert_texture64_pyramid.py`).
* The celebA-HQ-160 sequential chains (`configs/ve/srflow/celebAHQ160/
  sequential/{haar,bicubic}/master_config.py`): scales 40, 80 and 160 of
  `srflow.hq160_sequential_config`.
* Their texture160 variants, on the in-repo texture160 test split, eval
  batch 8: the Haar chain decomposes the 160px GT images (no LQ file); the
  bicubic chain reads per-scale LQ/GT files that
  :func:`write_texture160_sequential_data` makes from them.
* ``_block`` variants of the chains with the fused resblock tail and the
  whole-resblock kernels on (``model.fused_tail``, ``model.fused_block``),
  as `texture160_sr_cmde_bf16_block.py` sets them.
"""

from __future__ import annotations

import math
import os
import pickle

from .base import Config, base_config
from .srflow import hq160_direct_8x_config, hq160_sequential_config

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
SEQUENTIAL_SIZES = (40, 80, 160)
TEXTURE160_SEQUENTIAL_DIR = os.path.join("logs", "texture160_sequential")


def pyramid_ema_asset(image_size: int) -> str:
    """The converted EMA file of the texture64 pyramid's scale ``image_size``."""
    return os.path.join(ASSETS, f"texture64_pyramid_scale{image_size}_ema.pt")


def texture64_haar_scale_config(image_size: int) -> Config:
    """One scale of the trained texture64 pyramid; ``image_size`` (32 or
    64) is the scale's output resolution.  Scale 32 works at 16px (y the
    16px DC band of a 2-level Haar decomposition, x its 9 detail
    channels); scale 64 at 32px (1 level)."""
    config = base_config()
    training = config.training
    training.batch_size = 64
    training.n_iters = 8001
    training.log_freq = 200
    training.eval_freq = 2000
    training.snapshot_freq = 2000
    training.visualization_freq = 4000
    training.likelihood_weighting = True
    training.continuous = True
    training.reduce_mean = True
    training.sde = "vesde"
    training.lightning_module = "haar_conditional_decreasing_variance"
    training.visualization_callback = "conditional_haar_multiscale"
    training.conditioning_approach = "ours_DV"

    sampling = config.sampling
    sampling.predictor = "conditional_reverse_diffusion"
    sampling.corrector = "conditional_langevin"
    sampling.snr = 0.16

    config.eval.batch_size = 8
    config.eval.max_val_batches = 2
    config.optim.warmup = 500
    config.optim.lr = 2e-4
    config.optim.grad_clip = 1.0

    data = config.data
    data.datamodule = "Haar_PKLDataset"
    data.dataset = "texture64"
    data.base_dir = "datasets"
    data.map = "approx to detail"
    data.target_resolution = 64
    data.image_size = image_size
    data.effective_image_size = image_size // 2
    data.scale = 2
    data.use_flip = True
    data.use_crop = False
    data.use_rot = False
    data.level = int(math.log(data.target_resolution // data.image_size, 2))
    data.range_x = [-(2**data.level), 2**data.level]
    data.range_y = [0, 2 ** (data.level + 1)]
    half = image_size // 2
    data.shape_x = [9, half, half]
    data.shape_y = [3, half, half]
    data.num_channels = 12

    model = config.model
    model.name = "ddpm_paired"
    model.num_scales = 1000
    model.sigma_min_x = 5e-3
    model.sigma_min_y = 5e-3
    model.sigma_min_y_target = 5e-3
    model.sigma_max_x = float(math.sqrt(math.prod(data.shape_x)) * (data.range_x[1] - data.range_x[0]))
    model.sigma_max_y = float(math.sqrt(math.prod(data.shape_y)) * (data.range_y[1] - data.range_y[0]))
    model.sigma_max_y_target = model.sigma_max_y / 2
    model.reach_target_steps = 4000
    model.ema_rate = 0.999
    model.dropout = 0.1
    model.embedding_type = "positional"
    model.nf = 48
    model.ch_mult = (1, 2) if image_size == 32 else (1, 1, 2)
    model.num_res_blocks = 2
    model.attn_resolutions = (8,)
    model.resamp_with_conv = True
    model.conditional = True
    model.scale_by_sigma = True
    model.input_channels = data.num_channels
    model.output_channels = data.num_channels

    config.logging = Config(log_path=f"artifacts/texture64_pyramid/scale_{image_size}")
    model.checkpoint_path = pyramid_ema_asset(image_size)
    return config


def _with_kernels(config: Config) -> Config:
    config.model.fused_tail = True
    config.model.fused_block = True
    return config


def _master(space: str, scales: dict) -> Config:
    return Config(coordinate_space=space, **scales)


def texture64_multiscale_master_config() -> Config:
    """The trained texture64 pyramid: 16px DC -> 32px -> 64px, Haar space."""
    return _master("haar", {f"scale_{s}": texture64_haar_scale_config(s) for s in (32, 64)})


def texture64_multiscale_master_block_config() -> Config:
    """The trained pyramid with kernels 1-3 on in both scales."""
    return _master("haar", {f"scale_{s}": _with_kernels(texture64_haar_scale_config(s)) for s in (32, 64)})


def hq160_sequential_master_config(space: str) -> Config:
    """The celebA-HQ-160 sequential chain 20 -> 40 -> 80 -> 160 in
    ``space`` (``haar`` or ``bicubic``)."""
    return _master(space, {f"config_{s}": hq160_sequential_config(s, space) for s in SEQUENTIAL_SIZES})


def hq160_sequential_haar_master_config() -> Config:
    return hq160_sequential_master_config("haar")


def hq160_sequential_bicubic_master_config() -> Config:
    return hq160_sequential_master_config("bicubic")


def texture160_sequential_config(image_size: int, space: str, base_dir: str = "datasets") -> Config:
    """One scale of the sequential chain on the texture160 test split, eval
    batch 8.  Haar: the ``texture160`` dataset under ``base_dir``; bicubic:
    ``texture160_{image_size}`` under ``base_dir`` (the files of
    :func:`write_texture160_sequential_data`)."""
    config = hq160_sequential_config(image_size, space)
    config.data.dataset = "texture160" if space == "haar" else f"texture160_{image_size}"
    config.data.base_dir = base_dir
    config.eval.batch_size = 8
    return config


def write_texture160_sequential_data(base_dir: str = TEXTURE160_SEQUENTIAL_DIR, source_dir: str = "datasets") -> str:
    """The bicubic chain's test files from the texture160 test split, where
    absent: ``{base_dir}/texture160_{s}/texture160_{s}-test.pklv4`` (the GT
    images resized bicubic to ``s``, or as they are at 160) and its ``_X2``
    LQ file, for ``s`` in 40, 80, 160, by the expression the repo's dataset
    script writes its LQ files with (`data.degradations.bicubic_lq_images`).
    Returns ``base_dir``."""
    from ..data.degradations import bicubic_lq_images
    from ..data.pkl_datasets import load_pkl_images

    gt160 = None
    for s in SEQUENTIAL_SIZES:
        d = os.path.join(base_dir, f"texture160_{s}")
        gt_path, lq_path = (os.path.join(d, f"texture160_{s}-test{x}.pklv4") for x in ("", "_X2"))
        if os.path.exists(gt_path) and os.path.exists(lq_path):
            continue
        if gt160 is None:
            gt160 = load_pkl_images(os.path.join(source_dir, "texture160", "texture160-test.pklv4"))
        gt = gt160 if s == 160 else bicubic_lq_images(gt160, 160 // s)
        os.makedirs(d, exist_ok=True)
        for path, images in ((gt_path, gt), (lq_path, bicubic_lq_images(gt, 2))):
            with open(f"{path}.{os.getpid()}.tmp", "wb") as f:
                pickle.dump(images, f, protocol=4)
            os.replace(f"{path}.{os.getpid()}.tmp", path)
    return base_dir


def texture160_sequential_master_config(
    space: str, base_dir: str = None, block: bool = False, source_dir: str = "datasets"
) -> Config:
    """The sequential chain on texture160 in ``space``; the bicubic chain's
    files are written under ``base_dir`` first where absent, from the
    texture160 test split under ``source_dir``.  ``block``: with kernels 1-3
    on in every scale."""
    if space == "bicubic":
        base_dir = write_texture160_sequential_data(base_dir or TEXTURE160_SEQUENTIAL_DIR, source_dir)
    scales = {}
    for s in SEQUENTIAL_SIZES:
        config = texture160_sequential_config(s, space, base_dir or "datasets")
        scales[f"config_{s}"] = _with_kernels(config) if block else config
    return _master(space, scales)


def texture160_sequential_haar_master_config() -> Config:
    return texture160_sequential_master_config("haar")


def texture160_sequential_haar_master_block_config() -> Config:
    return texture160_sequential_master_config("haar", block=True)


def texture160_sequential_bicubic_master_config() -> Config:
    return texture160_sequential_master_config("bicubic")


def texture160_sequential_bicubic_master_block_config() -> Config:
    return texture160_sequential_master_config("bicubic", block=True)


def texture160_direct_8x_config(block: bool = False) -> Config:
    """`srflow.hq160_direct_8x_config` on the texture160 test split, eval
    batch 8 (``block``: kernels 1-3 on)."""
    config = hq160_direct_8x_config()
    config.data.dataset = "texture160"
    config.data.base_dir = "datasets"
    config.eval.batch_size = 8
    return _with_kernels(config) if block else config


def texture160_direct_8x_block_config() -> Config:
    return texture160_direct_8x_config(block=True)
