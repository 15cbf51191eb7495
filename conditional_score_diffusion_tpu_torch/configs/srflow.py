"""The DF2K direct 4x super-resolution recipe (NCSN++ ``ncsnpp_KxSR`` under
VS-CMDE), copied from the JAX package's `configs/srflow.py`: `_srflow_base`
and `df2k_config("direct")` (`configs/ve/srflow/DF2K/direct/4x.py`).

The sequential 2x DF2K stages (``80to160``, ``40to80``) need ``ddpm_2xSR``,
which is not ported; asking for them raises.
"""

from __future__ import annotations

import math

from .base import Config, base_config


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
    """DF2K direct 4x: 160px HR, 40px LR, NCSN++ nf=64 with BigGAN blocks,
    FIR resampling and progressive input/output pyramids, multi-speed VE SDE
    with sigma_y,max annealed to half over 8000 steps."""
    if kind != "direct":
        raise NotImplementedError(f"DF2K recipe {kind!r} is not ported; only 'direct' is")
    config = _srflow_base(16, 2, continuous=True)
    config.eval.batch_size = 32

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
    data.image_size = 160
    data.effective_image_size = 160
    data.scale = 4
    data.shape_x = [3, 160, 160]
    data.num_channels = 6

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
    model.name = "ncsnpp_KxSR"
    model.sigma_max_x = 160 * float(math.sqrt(3))
    model.nf = 64
    model.ch_mult = (1, 1, 2, 2, 4, 4)
    model.sigma_max_y = model.sigma_max_x
    model.sigma_max_y_target = model.sigma_max_y / 2
    model.input_channels = data.num_channels
    model.output_channels = data.num_channels
    return config
