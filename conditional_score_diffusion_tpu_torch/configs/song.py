"""The score_sde recipe family, copied from the JAX package's
`configs/song.py`: the per-dataset defaults (`get_default_configs`, every
recipe on the ``image`` datamodule) and the shared model sections of the
recipe files under `configs/{ve,vp,subvp}/` (`configs/score_sde.py` reads
those files' recipes by path).
"""

from __future__ import annotations

from .base import Config, base_config

# (batch, n_iters, preempt_freq, snr, begin_ckpt, end_ckpt, eval_batch,
#  enable_sampling, dataset, image_size, sigma_max, num_scales, dropout)
_DATASETS = {
    "cifar10": (128, 1300001, 10000, 0.16, 9, 26, 1024, False, "CIFAR10", 32, 50.0, 1000, 0.1),
    "celeba": (128, 1300001, 10000, 0.17, 1, 26, 1024, True, "CELEBA", 64, 90.0, 1000, 0.1),
    "lsun": (64, 2400001, 5000, 0.075, 50, 96, 512, True, "LSUN", 256, 378.0, 2000, 0.0),
}


def get_default_configs(dataset: str = "cifar10") -> Config:
    """The reference's per-dataset default config, on the repo schema.

    Values match `configs/default_<dataset>_configs.py` exactly; repo-side
    plumbing (datamodule/shape) is filled in so the configs are runnable.
    """
    (batch, n_iters, preempt, snr, begin, end, eval_batch, enable_sampling,
     name, size, sigma_max, num_scales, dropout) = _DATASETS[dataset]

    config = base_config()
    training = config.training
    training.batch_size = batch
    training.n_iters = n_iters
    training.snapshot_freq = 50000
    training.log_freq = 50
    training.eval_freq = 100
    training.snapshot_freq_for_preemption = preempt
    training.snapshot_sampling = True
    training.likelihood_weighting = False
    training.continuous = True
    training.reduce_mean = False

    sampling = config.sampling
    sampling.n_steps_each = 1
    sampling.noise_removal = True
    sampling.probability_flow = False
    sampling.snr = snr

    evaluate = config.eval
    evaluate.begin_ckpt = begin
    evaluate.end_ckpt = end
    evaluate.batch_size = eval_batch
    evaluate.enable_sampling = enable_sampling

    data = config.data
    data.dataset = name
    data.datamodule = "image"
    data.image_size = size
    data.effective_image_size = size
    data.random_flip = True
    data.centered = False
    data.uniform_dequantization = False
    data.num_channels = 3
    data.shape = [3, size, size]

    model = config.model
    model.sigma_min = 0.01
    model.sigma_max = sigma_max
    model.num_scales = num_scales
    model.beta_min = 0.1
    model.beta_max = 20.0
    model.dropout = dropout
    model.embedding_type = "fourier"

    optim = config.optim
    optim.lr = 2e-4
    optim.warmup = 5000
    optim.grad_clip = 1.0
    return config


def ncsnpp_block(model, *, deep: bool = False) -> None:
    """The standard CIFAR/CelebA NCSN++ model section
    (reference `configs/ve/cifar10_ncsnpp_continuous.py:35-57`)."""
    model.name = "ncsnpp"
    model.scale_by_sigma = True
    model.ema_rate = 0.999
    model.normalization = "GroupNorm"
    model.nonlinearity = "swish"
    model.nf = 128
    model.ch_mult = (1, 2, 2, 2)
    model.num_res_blocks = 8 if deep else 4
    model.attn_resolutions = (16,)
    model.resamp_with_conv = True
    model.conditional = True
    model.fir = True
    model.fir_kernel = [1, 3, 3, 1]
    model.skip_rescale = True
    model.resblock_type = "biggan"
    model.progressive = "none"
    model.progressive_input = "residual"
    model.progressive_combine = "sum"
    model.attention_type = "ddpm"
    model.init_scale = 0.0
    model.fourier_scale = 16
    model.conv_size = 3


def ncsnpp_lsun_block(model) -> None:
    """The high-resolution (LSUN/CelebAHQ-256/FFHQ-256) NCSN++ section
    (reference `configs/ve/bedroom_ncsnpp_continuous.py:34-58`)."""
    ncsnpp_block(model)
    model.ch_mult = (1, 1, 2, 2, 2, 2, 2)
    model.num_res_blocks = 2
    model.progressive = "output_skip"
    model.progressive_input = "input_skip"


def ddpmpp_block(model, *, deep: bool = False) -> None:
    """The VP/subVP `DDPM++` section (NCSN++ arch without FIR/progressive;
    reference `configs/vp/cifar10_ddpmpp.py:37-60`)."""
    ncsnpp_block(model, deep=deep)
    model.scale_by_sigma = False
    model.ema_rate = 0.9999
    model.fir = False
    model.progressive_input = "none"
    model.embedding_type = "positional"


def ddpm_block(model) -> None:
    """The classic DDPM U-Net section (reference `configs/ve/cifar10_ddpm.py:35-50`)."""
    model.name = "ddpm"
    model.scale_by_sigma = True
    model.ema_rate = 0.999
    model.normalization = "GroupNorm"
    model.nonlinearity = "swish"
    model.nf = 128
    model.ch_mult = (1, 2, 2, 2)
    model.num_res_blocks = 2
    model.attn_resolutions = (16,)
    model.resamp_with_conv = True
    model.conditional = True
    model.conv_size = 3
    model.input_channels = 3
    model.output_channels = 3


def ffhq_1024_config(dataset: str = "FFHQ") -> Config:
    """The standalone 1024px NCSN++ recipe shared by FFHQ and CelebAHQ
    (reference `configs/ve/ffhq_ncsnpp_continuous.py`,
    `configs/ve/celebahq_ncsnpp_continuous.py`)."""
    config = get_default_configs("lsun")
    training = config.training
    training.batch_size = 8
    training.sde = "vesde"
    training.continuous = True
    training.reduce_mean = dataset == "FFHQ"

    sampling = config.sampling
    sampling.method = "pc"
    sampling.predictor = "reverse_diffusion"
    sampling.corrector = "langevin"
    sampling.snr = 0.15

    evaluate = config.eval
    evaluate.begin_ckpt = 1
    evaluate.end_ckpt = 96
    evaluate.batch_size = 1024

    data = config.data
    data.dataset = dataset
    size = 1024
    data.image_size = size
    data.effective_image_size = size
    data.shape = [3, size, size]

    model = config.model
    ncsnpp_lsun_block(model)
    model.sigma_max = 1348.0
    model.num_scales = 2000
    model.ema_rate = 0.9999
    model.nf = 16
    model.ch_mult = (1, 2, 4, 8, 16, 32, 32, 32)
    model.num_res_blocks = 1
    model.dropout = 0.0
    model.embedding_type = "fourier"
    return config
