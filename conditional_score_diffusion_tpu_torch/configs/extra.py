"""Six recipes of the JAX package's `configs/extra.py`, copied: MRI->PET
on paired scans, 2-D slices or 3-D volumes (`mri_to_pet_config`), the
unconditional VE NCSN++ on a `.pklv4` image list (`unconditional_pkl_config`),
CIFAR-10 under a VP or sub-VP SDE (`cifar10_vp_config`, DDPM++
continuous on the ``ncsnpp`` graph), the unconditional DDPM of Haar
coefficients (`haar_multiscale_unconditional_config`), the conditional
Haar VS-CMDE of detail bands given the approximation band
(`haar_conditional_config`) and the Haar-space DDPM of celebaHQ under VE or
VP (`haarflow_config`); the texture160 variant of the second
(`texture160_unconditional_ncsnpp_config`), and the texture64 variant of
the fourth with its fused twin (`texture64_haar_multiscale_unconditional_config`,
`..._block_config`)."""

from __future__ import annotations

import math

from .base import Config, base_config, image_model_defaults


def mri_to_pet_config(volumetric: bool = False, approach: str = "ours_DV") -> Config:
    """MRI->PET paired scans (JAX `configs/extra.py:mri_to_pet_config`):
    96px one-channel slices through ``ddpm_paired`` (nf 96, ch_mult
    (1, 1, 2, 2, 3, 3), attention at 12/6), or [1, 96, 96, 16] volumes
    through ``ddpm3D_paired`` (nf 32, ch_mult (1, 2, 2), no attention);
    ``sr3`` takes the ``_SR3`` models."""
    config = base_config()
    training = config.training
    training.lightning_module = "conditional_decreasing_variance" if approach == "ours_DV" else "conditional"
    training.conditioning_approach = approach
    training.batch_size = 4 if volumetric else 32
    training.visualization_callback = "paired3D" if volumetric else "paired"
    training.sde = "vesde"

    sampling = config.sampling
    sampling.predictor = "conditional_reverse_diffusion"
    sampling.corrector = "conditional_langevin"

    data = config.data
    data.dataset = "mri_to_pet"
    data.task = "image-to-image"
    data.datamodule = "paired"
    size = 96
    data.image_size = size
    data.effective_image_size = size
    if volumetric:
        data.shape_x = [1, size, size, 16]
        data.shape_y = [1, size, size, 16]
    else:
        data.shape_x = [1, size, size]
        data.shape_y = [1, size, size]
    data.num_channels = 2
    data.use_flip = True
    # per-domain intensity ranges (`data.paired.normalise`)
    data.range_y = (0.0, 255.0)
    data.range_x = (0.0, 255.0)

    model = config.model
    model.num_scales = 1000
    model.sigma_max_x = float(math.sqrt(math.prod(data.shape_x)))
    model.sigma_min_x = 5e-3
    model.sigma_min_y = 5e-3
    model.sigma_max_y = float(math.sqrt(math.prod(data.shape_y)))
    model.sigma_max_y_target = 1.0
    model.sigma_min_y_target = 5e-3
    model.reach_target_steps = training.n_iters
    if volumetric:
        model.name = "ddpm3D_paired_SR3" if approach == "sr3" else "ddpm3D_paired"
    else:
        model.name = "ddpm_paired_SR3" if approach == "sr3" else "ddpm_paired"
    image_model_defaults(model)
    model.nf = 32 if volumetric else 96
    model.ch_mult = (1, 2, 2) if volumetric else (1, 1, 2, 2, 3, 3)
    model.attn_resolutions = () if volumetric else (12, 6)
    model.input_channels = 2
    model.output_channels = 1 if approach == "sr3" else 2
    return config


def unconditional_pkl_config(image_size: int = 64) -> Config:
    """Unconditional NCSN++ on celebA-HQ pklv4 (JAX
    `configs/extra.py:unconditional_pkl_config`): nf=128, ch_mult
    (1, 1, 2, 2), attention at 16, FIR, BigGAN resblocks, VE."""
    config = base_config()
    config.experiment_name = f"ve_celebAHQ_{image_size}"
    config.training.lightning_module = "base"
    config.training.sde = "vesde"
    config.training.likelihood_weighting = False
    config.training.reduce_mean = False

    data = config.data
    data.dataset = "celebA-HQ-160"
    data.datamodule = "unpaired_PKLDataset"
    data.image_size = image_size
    data.effective_image_size = image_size
    data.shape = [3, image_size, image_size]
    data.num_channels = 3
    data.use_flip = True

    model = config.model
    model.sigma_max = float(math.sqrt(math.prod(data.shape)))
    model.sigma_min = 5e-3
    model.name = "ncsnpp"
    image_model_defaults(model)
    model.nf = 128
    model.ch_mult = (1, 1, 2, 2)
    model.attn_resolutions = (16,)
    model.num_scales = 1000
    return config


def texture160_unconditional_ncsnpp_config() -> Config:
    """`unconditional_pkl_config(128)` on the in-repo texture160 patches
    (resized bicubic from 160 to 128 by `unpaired_PKLDataset`); nothing
    else changed."""
    config = unconditional_pkl_config(128)
    config.data.dataset = "texture160"
    config.data.base_dir = "datasets"
    return config


def haar_multiscale_unconditional_config(image_size: int = 64) -> Config:
    """Unconditional generation in Haar space (JAX
    `configs/extra.py:haar_multiscale_unconditional_config`): a VE DDPM,
    nf=128, ch_mult (1, 1, 2, 2), attention at 16 and 8, on the 12 Haar
    channels of a level-0 image at ``image_size // 2``, read by the
    ``haar_multiscale`` datamodule."""
    config = base_config()
    config.training.lightning_module = "haar_multiscale"
    config.training.sde = "vesde"
    config.training.visualization_callback = "haar_multiscale"

    data = config.data
    data.dataset = "celebA"
    data.datamodule = "haar_multiscale"
    data.image_size = image_size
    data.level = 0
    data.effective_image_size = image_size // 2
    data.shape = [12, image_size // 2, image_size // 2]
    data.num_channels = 12

    model = config.model
    model.sigma_max = float(math.sqrt(math.prod(data.shape)))
    model.sigma_min = 5e-3
    model.name = "ddpm"
    image_model_defaults(model)
    model.nf = 128
    model.ch_mult = (1, 1, 2, 2)
    model.attn_resolutions = (16, 8)
    model.input_channels = 12
    model.output_channels = 12
    model.num_scales = 1000
    return config


def haar_conditional_config(image_size: int = 128, target_resolution: int = 256) -> Config:
    """Conditional Haar VS-CMDE (JAX `configs/extra.py:haar_conditional_config`,
    `configs/ve/haarflow/haar_128.py`): ``ddpm_paired`` nf=128, ch_mult
    (1, 1, 2, 2, 3, 3), the 9 detail bands given the approximation band of
    one Haar level at ``image_size // 2``, `Haar_PKLDataset` on celebA-HQ-160."""
    config = base_config()
    training = config.training
    training.lightning_module = "haar_conditional_decreasing_variance"
    training.conditioning_approach = "ours_DV"
    training.batch_size = 32
    training.sde = "vesde"
    training.visualization_callback = "haar_multiscale"

    sampling = config.sampling
    sampling.predictor = "conditional_reverse_diffusion"
    sampling.corrector = "conditional_langevin"

    data = config.data
    data.dataset = "celebA-HQ-160"
    data.task = "multi_scale"
    data.datamodule = "Haar_PKLDataset"
    data.map = "approx to detail"
    data.image_size = image_size
    data.target_resolution = target_resolution
    data.level = int(math.log2(target_resolution // image_size))
    data.effective_image_size = image_size // 2
    data.shape_x = [9, image_size // 2, image_size // 2]
    data.shape_y = [3, image_size // 2, image_size // 2]
    data.num_channels = 12
    data.use_flip = True
    data.use_crop = False
    data.use_rot = False
    data.max_haar_depth = 4

    model = config.model
    model.num_scales = 1000
    model.sigma_max_x = float(math.sqrt(math.prod(data.shape_x)))
    model.sigma_min_x = 5e-3
    model.sigma_min_y = 5e-3
    model.sigma_max_y = float(math.sqrt(math.prod(data.shape_y)))
    model.sigma_max_y_target = 1.0
    model.sigma_min_y_target = 5e-3
    model.reach_target_steps = training.n_iters
    model.name = "ddpm_paired"
    image_model_defaults(model)
    model.nf = 128
    model.ch_mult = (1, 1, 2, 2, 3, 3)
    model.attn_resolutions = (16, 8)
    model.input_channels = 12
    model.output_channels = 12
    return config


def haarflow_config(image_size: int = 128, sde: str = "vesde") -> Config:
    """The Haar-space DDPM of celebaHQ (JAX `configs/extra.py:haarflow_config`,
    `configs/ve/haarflow/128.py`, `configs/vp/haarflow/celebahq.py`): nf=128
    on the 12 Haar channels of a level-0 image at ``image_size // 2``, read
    by the ``haar_multiscale`` datamodule.  VE: VS-CMDE
    (``conditional_decreasing_variance``; the 9 detail bands given the
    approximation band, `training/tasks.py`), ch_mult (1, 1, 2, 2, 3, 3),
    attention at 16, 8 and 4, B=32; VP: unconditional (``base``), ch_mult
    (1, 1, 2, 2, 4, 4), B=64."""
    ve = sde == "vesde"
    config = base_config()
    training = config.training
    training.sde = sde
    training.lightning_module = "conditional_decreasing_variance" if ve else "base"
    training.batch_size = 32 if ve else 64
    training.n_iters = 2400001
    training.log_freq = 250 if ve else 50
    training.likelihood_weighting = ve
    training.continuous = not ve
    training.reduce_mean = ve
    training.visualization_callback = "haar_multiscale"

    sampling = config.sampling
    sampling.predictor = "conditional_reverse_diffusion" if ve else "reverse_diffusion"
    sampling.corrector = "conditional_langevin" if ve else "langevin"
    sampling.snr = 0.16 if ve else 0.075

    config.eval.batch_size = 36 if ve else 512

    data = config.data
    data.dataset = "celebaHQ"
    data.datamodule = "haar_multiscale"
    data.highest_resolution = 1024
    data.target_resolution = image_size
    data.image_size = image_size
    data.level = math.log(data.target_resolution // data.image_size, 2)
    data.effective_image_size = image_size // 2
    data.max_haar_depth = 4 if ve else 3
    data.num_channels = 12
    data.shape = [12, image_size // 2, image_size // 2]
    data.shape_x = [9, image_size // 2, image_size // 2]
    data.shape_y = [3, image_size // 2, image_size // 2]

    model = config.model
    model.num_scales = 1000
    model.sigma_max = 320 if ve else 378
    model.sigma_min = 0.01
    model.sigma_max_x = model.sigma_max
    model.sigma_max_y = model.sigma_max
    model.sigma_max_y_target = 1.0
    model.sigma_min_x = 0.01
    model.sigma_min_y = 0.01
    model.sigma_min_y_target = 0.01
    model.reach_target_steps = 250000
    model.beta_min = 0.1
    model.beta_max = (20.0 + 4 * (data.level + 1) * math.log(2)) if ve else 20.0
    model.dropout = 0.1 if ve else 0.0
    model.embedding_type = "fourier"
    model.name = "ddpm"
    model.scale_by_sigma = ve
    model.ema_rate = 0.999 if ve else 0.9999
    model.normalization = "GroupNorm"
    model.nonlinearity = "swish"
    model.nf = 128
    model.ch_mult = (1, 1, 2, 2, 3, 3) if ve else (1, 1, 2, 2, 4, 4)
    model.num_res_blocks = 2
    model.attn_resolutions = (16, 8, 4) if ve else (16,)
    model.resamp_with_conv = True
    model.conditional = True
    model.conv_size = 3
    model.input_channels = 12
    model.output_channels = 12

    config.optim.lr = 2e-4 if ve else 2e-5
    config.optim.warmup = 5000
    return config


def texture64_haar_multiscale_unconditional_config() -> Config:
    """`haar_multiscale_unconditional_config(64)` on the in-repo texture64
    split (32x32x12 coefficients); nothing else changed."""
    config = haar_multiscale_unconditional_config(64)
    config.data.dataset = "texture64"
    config.data.base_dir = "datasets"
    return config


def texture64_haar_multiscale_unconditional_block_config() -> Config:
    """The same with ``fused_block`` and ``fused_tail`` on: kernels 1-3 at
    16x16 and below."""
    config = texture64_haar_multiscale_unconditional_config()
    config.model.fused_block = True
    config.model.fused_tail = True
    return config


def cifar10_vp_config(sde: str = "vpsde", model_name: str = "ncsnpp") -> Config:
    """CIFAR-10 with a VP or sub-VP SDE (JAX
    `configs/extra.py:cifar10_vp_config`): nf=128, 4 resblocks a level,
    32px, no FIR, Euler-Maruyama without a corrector."""
    config = base_config()
    config.training.sde = sde
    config.training.continuous = True
    config.training.likelihood_weighting = sde == "subvpsde"
    config.training.reduce_mean = True
    config.sampling.method = "pc"
    config.sampling.predictor = "euler_maruyama"
    config.sampling.corrector = "none"
    config.sampling.snr = 0.16

    data = config.data
    data.dataset = "CIFAR10"
    data.datamodule = "image"
    data.image_size = 32
    data.effective_image_size = 32
    data.centered = True
    data.shape = [3, 32, 32]
    data.num_channels = 3

    model = config.model
    model.name = model_name
    image_model_defaults(model)
    model.nf = 128
    model.ch_mult = (1, 2, 2, 2)
    model.num_res_blocks = 4
    model.attn_resolutions = (16,)
    model.embedding_type = "positional"
    model.fir = False
    model.resblock_type = "biggan"
    model.num_scales = 1000
    model.beta_min = 0.1
    model.beta_max = 20.0
    config.optim.warmup = 5000
    return config
