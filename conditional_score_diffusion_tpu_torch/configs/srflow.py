"""The SRFlow recipes, copied from the JAX package's `configs/srflow.py`:
`_srflow_base`; `df2k_config` (DF2K direct 4x, NCSN++ ``ncsnpp_KxSR``, and
the sequential 2x stages ``80to160`` and ``40to80``, ``ddpm_2xSR``, all
under VS-CMDE); `hq160_sequential_config` (the celebA-HQ-160 sequential 2x
chain in the ``bicubic`` space, ``ddpm_2xSR``, or the ``haar`` space,
``ddpm_paired`` on the detail bands); `hq160_direct_8x_config` (direct 8x,
``ddpm_KxSR``).  The celebA legacy multi-scale recipes wait for ROADMAP.md
section 1, item 12.
"""

from __future__ import annotations

import math

from .base import Config, base_config

# per-scale (batch, gpus) of the sequential chains
_SCALE_BATCH = {160: (32, 4), 80: (64, 2), 40: (128, 1)}

_NCSNPP_FIELDS = dict(
    fir=True,
    fir_kernel=[1, 3, 3, 1],
    skip_rescale=True,
    resblock_type="biggan",
    progressive="output_skip",
    progressive_input="input_skip",
    progressive_combine="sum",
    attention_type="ddpm",
    init_scale=0.0,
    fourier_scale=16,
    conv_size=3,
)


def _srflow_base(batch: int, gpus: int, *, snr: float = 0.16, continuous: bool = False) -> Config:
    config = base_config()
    training = config.training
    training.batch_size = batch
    training.gpus = gpus
    training.accelerator = None if gpus == 1 else "ddp"
    training.workers = 4 * gpus
    training.n_iters = 2400001
    training.likelihood_weighting = True
    training.continuous = continuous
    training.reduce_mean = True
    training.sde = "vesde"

    sampling = config.sampling
    sampling.predictor = "conditional_reverse_diffusion"
    sampling.corrector = "conditional_langevin"
    sampling.snr = snr

    config.eval.batch_size = batch
    config.optim.warmup = 5000
    return config


def df2k_config(kind: str = "direct") -> Config:
    """DF2K: ``direct`` 4x (160px HR, 40px LR, NCSN++ nf=64 with BigGAN
    blocks, FIR resampling and progressive input/output pyramids), or a
    sequential 2x stage ``80to160`` / ``40to80`` (``ddpm_2xSR``); multi-speed
    VE SDE with sigma_y,max annealed to half over 8000 steps."""
    if kind == "direct":
        config = _srflow_base(16, 2, continuous=True)
        config.eval.batch_size = 32
    elif kind in ("80to160", "40to80"):
        size = {"80to160": 160, "40to80": 80}[kind]
        config = _srflow_base(*_SCALE_BATCH[size], continuous=True)
    else:
        raise KeyError(f"unknown DF2K recipe {kind!r}; known: direct, 80to160, 40to80")

    training = config.training
    training.lightning_module = "conditional_decreasing_variance"
    training.visualization_callback = "KxSR"

    data = config.data
    data.dataset = "DF2K"
    data.datamodule = "LRHR_PKLDataset"
    data.use_data_mean = False
    data.target_resolution = 160
    data.use_flip = True
    data.use_rot = False
    data.use_crop = False
    data.uniform_dequantization = False

    model = config.model
    model.num_scales = 1000
    model.reach_target_steps = 8000
    model.sigma_min_x = 1e-2
    model.sigma_min_y = 1e-2
    model.sigma_min_y_target = 1e-2
    model.beta_max = 20.0
    model.embedding_type = "fourier"
    model.scale_by_sigma = True
    model.num_res_blocks = 2
    model.attn_resolutions = (20, 10, 5)
    model.resamp_with_conv = True
    model.conditional = True
    for k, v in _NCSNPP_FIELDS.items():
        setattr(model, k, v)

    if kind == "direct":
        data.image_size = 160
        data.effective_image_size = 160
        data.scale = 4
        data.shape_x = [3, 160, 160]
        data.num_channels = 6
        model.name = "ncsnpp_KxSR"
        model.sigma_max_x = 160 * float(math.sqrt(3))
        model.nf = 64
        model.ch_mult = (1, 1, 2, 2, 4, 4)
    else:
        data.image_size = size
        data.effective_image_size = size // 2
        data.scale = 2
        data.shape_x = [3, size, size]
        data.num_channels = 15
        model.name = "ddpm_2xSR"
        model.sigma_max_x = size * float(math.sqrt(3))
        model.nf = {160: 64, 80: 96}[size]
        model.ch_mult = {160: (1, 1, 2, 2, 4), 80: (1, 1, 2, 2)}[size]
    model.sigma_max_y = model.sigma_max_x
    model.sigma_max_y_target = model.sigma_max_y / 2
    model.input_channels = data.num_channels
    model.output_channels = data.num_channels
    return config


def hq160_sequential_config(image_size: int, space: str) -> Config:
    """One scale (``image_size`` 40, 80 or 160) of the celebA-HQ-160
    sequential 2x-per-stage chain, in the ``bicubic`` space (``ddpm_2xSR``
    on stored LQ/GT pairs) or the ``haar`` space (``ddpm_paired``: the
    detail bands of the image given its approximation band, by
    `Haar_PKLDataset`)."""
    if space not in ("haar", "bicubic"):
        raise KeyError(f"unknown coordinate space {space!r}; known: haar, bicubic")
    batch, gpus = _SCALE_BATCH[image_size]
    config = _srflow_base(batch, gpus, continuous=True)
    training = config.training

    data = config.data
    data.dataset = "celebA-HQ-160"
    data.coordinate_space = space
    data.use_data_mean = False
    data.target_resolution = 160
    data.image_size = image_size
    data.effective_image_size = image_size // 2
    data.scale = 2
    data.use_flip = True
    data.use_rot = False
    data.uniform_dequantization = False

    model = config.model
    model.num_scales = 1000
    model.reach_target_steps = 8000
    model.sigma_min_x = 5e-3
    model.sigma_min_y = 5e-3
    model.sigma_min_y_target = 5e-3
    model.beta_max = 20.0
    model.embedding_type = "fourier"
    model.scale_by_sigma = True
    model.nf = {160: 64, 80: 96, 40: 96}[image_size]
    model.ch_mult = {160: (1, 1, 2, 2, 4), 80: (1, 1, 2, 2), 40: (1, 1, 2)}[image_size]
    model.num_res_blocks = 2
    model.attn_resolutions = (20, 10, 5)
    model.resamp_with_conv = True
    model.conditional = True
    for k, v in _NCSNPP_FIELDS.items():
        setattr(model, k, v)

    if space == "bicubic":
        training.lightning_module = "conditional_decreasing_variance"
        training.visualization_callback = "KxSR"
        data.datamodule = "LRHR_PKLDataset"
        data.use_crop = False
        data.shape_x = [3, image_size, image_size]
        data.shape_y = [3, image_size // 2, image_size // 2]
        data.num_channels = 3 + 12  # squeezed HR 12 + LR 3
        model.name = "ddpm_2xSR"
        model.sigma_max_x = float(math.sqrt(math.prod(data.shape_x)))
        model.sigma_max_y = float(math.sqrt(math.prod(data.shape_y)))
    else:
        training.lightning_module = "haar_conditional_decreasing_variance"
        training.visualization_callback = "conditional_haar_multiscale"
        data.datamodule = "Haar_PKLDataset"
        data.map = "approx to detail"
        data.use_crop = True
        data.level = math.log(data.target_resolution // data.image_size, 2)
        data.range_x = [-(2**data.level), 2**data.level]
        data.range_y = [0, 2 ** (data.level + 1)]
        data.shape_x = [9, image_size // 2, image_size // 2]
        data.shape_y = [3, image_size // 2, image_size // 2]
        data.num_channels = 12
        model.name = "ddpm_paired"
        model.sigma_max_x = float(math.sqrt(math.prod(data.shape_x)) * (data.range_x[1] - data.range_x[0]))
        model.sigma_max_y = float(math.sqrt(math.prod(data.shape_y)) * (data.range_y[1] - data.range_y[0]))
    model.sigma_max_y_target = model.sigma_max_y / 2
    model.input_channels = data.num_channels
    model.output_channels = data.num_channels
    return config


def hq160_direct_8x_config() -> Config:
    """Direct 8x celebA-HQ-160 super-resolution with ``ddpm_KxSR`` (nf=96,
    ch_mult (1, 1, 2, 2, 3, 3)): the 20px LQ resized bilinearly to 160px
    beside x."""
    config = _srflow_base(16, 4, snr=0.15, continuous=True)
    training = config.training
    training.lightning_module = "conditional_decreasing_variance"
    training.visualization_callback = "KxSR"
    config.eval.batch_size = 16

    data = config.data
    data.dataset = "celebA-HQ-160"
    data.datamodule = "LRHR_PKLDataset"
    data.use_data_mean = False
    data.target_resolution = 160
    data.image_size = 160
    data.effective_image_size = 160
    data.scale = 8
    data.shape_x = [3, 160, 160]
    data.shape_y = [3, 160, 160]
    data.num_channels = 6
    data.use_flip = True
    data.use_rot = False
    data.use_crop = False
    data.uniform_dequantization = False

    model = config.model
    model.num_scales = 1000
    model.reach_target_steps = 4000
    model.sigma_max_x = float(math.sqrt(math.prod(data.shape_x)))
    model.sigma_max_y = float(math.sqrt(math.prod(data.shape_y)))
    model.sigma_max_y_target = model.sigma_max_y / 2
    model.sigma_min_x = 5e-3
    model.sigma_min_y = 5e-3
    model.sigma_min_y_target = 5e-3
    model.beta_max = 20.0
    model.embedding_type = "fourier"
    model.name = "ddpm_KxSR"
    model.scale_by_sigma = True
    model.nf = 96
    model.ch_mult = (1, 1, 2, 2, 3, 3)
    model.num_res_blocks = 2
    model.attn_resolutions = (20, 10, 5)
    model.resamp_with_conv = True
    model.conditional = True
    for k, v in _NCSNPP_FIELDS.items():
        setattr(model, k, v)
    model.input_channels = 6
    model.output_channels = 6
    return config
