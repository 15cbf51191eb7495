"""The legacy NCSN / NCSNv2 recipes, copied from the JAX package's
`configs/ncsn_legacy.py`: NCSNv1 with its technique variants (the files of
`configs/ve/ncsn/`), NCSNv2 (`configs/ve/ncsnv2/`) and the CelebA-64
architecture sweep (`configs/ve/jan/`).  The NCSN recipes train with the
discrete SMLD loss and sample with annealed Langevin dynamics (predictor
``none``, corrector ``ald``); the sweep's ``ncsnv2`` recipe trains
continuously and samples with reverse diffusion + Langevin.
"""

from __future__ import annotations

from .base import Config
from .song import get_default_configs

# NCSNv1 technique variants: (n_steps_each, snr, num_scales, sigma_max?, ema)
_NCSN_VARIANTS = {
    # reproduce-the-paper settings (reference configs/ve/ncsn/cifar10.py)
    "cifar10": {"v1": (100, 0.316, 10, 1.0, 0.0), "124": (5, 0.176, 232, None, 0.0),
                "1245": (5, 0.176, 232, None, 0.999), "5": (100, 0.316, 10, 1.0, 0.999)},
    "celeba": {"v1": (100, 0.316, 10, 1.0, 0.0), "124": (5, 0.128, 500, None, 0.0),
               "1245": (5, 0.128, 500, None, 0.999), "5": (100, 0.316, 10, 1.0, 0.999)},
}


def _ald_sampling(config, n_steps_each: int, snr: float) -> None:
    sampling = config.sampling
    sampling.method = "pc"
    sampling.predictor = "none"
    sampling.corrector = "ald"
    sampling.n_steps_each = n_steps_each
    sampling.snr = snr


def _legacy_optim(config, lr: float) -> None:
    optim = config.optim
    optim.weight_decay = 0
    optim.optimizer = "Adam"
    optim.lr = lr
    optim.beta1 = 0.9
    optim.amsgrad = False
    optim.eps = 1e-8
    optim.warmup = 0
    optim.grad_clip = -1.0


def ncsn_config(dataset: str, variant: str = "v1") -> Config:
    """NCSNv1 on CIFAR-10/CelebA, per-technique variants 124/1245/5
    (reference `configs/ve/ncsn/{cifar10,celeba}{,_124,_1245,_5}.py`)."""
    n_steps, snr, num_scales, sigma_max, ema = _NCSN_VARIANTS[dataset][variant]
    config = get_default_configs(dataset)
    config.training.sde = "vesde"
    config.training.continuous = False
    _ald_sampling(config, n_steps, snr)

    model = config.model
    model.name = "ncsn"
    model.scale_by_sigma = False
    if sigma_max is not None:
        model.sigma_max = sigma_max
    model.num_scales = num_scales
    model.ema_rate = ema
    model.normalization = "InstanceNorm++"
    model.nonlinearity = "elu"
    model.nf = 128
    model.interpolation = "bilinear"
    _legacy_optim(config, 1e-3)
    return config


def ncsnv2_config(dataset: str) -> Config:
    """NCSNv2 on CIFAR-10/CelebA/LSUN-bedroom
    (reference `configs/ve/ncsnv2/{cifar10,celeba,bedroom}.py`)."""
    if dataset == "bedroom":
        config = get_default_configs("lsun")
        config.training.batch_size = 128
        config.data.category = "bedroom"
        config.data.image_size = 128
        config.data.effective_image_size = 128
        config.data.shape = [3, 128, 128]
        _ald_sampling(config, 3, 0.095)
        name, num_scales, ema = "ncsnv2_128", 1086, 0.9999
        config.model.sigma_max = 190.0
        config.model.sigma_min = 0.01
    else:
        config = get_default_configs(dataset)
        snr = 0.176 if dataset == "cifar10" else 0.128
        _ald_sampling(config, 5, snr)
        name = "ncsnv2_64"
        num_scales = 232 if dataset == "cifar10" else 500
        ema = 0.999
    config.training.sde = "vesde"
    config.training.continuous = False

    model = config.model
    model.name = name
    model.scale_by_sigma = True
    model.num_scales = num_scales
    model.ema_rate = ema
    model.normalization = "InstanceNorm++"
    model.nonlinearity = "elu"
    model.nf = 128
    model.interpolation = "bilinear"
    _legacy_optim(config, 1e-4)
    return config


def jan_celeba64_config(arch: str) -> Config:
    """The `jan` CelebA-64 comparison sweep: same data/training recipe, one
    config per architecture (reference `configs/ve/jan/{ddpm,ncsn,ncsnv2}/celeba_64.py`)."""
    config = get_default_configs("celeba")
    training = config.training
    training.batch_size = 128 if arch == "ncsnv2" else 32
    training.workers = 4
    training.num_epochs = 10000
    training.n_iters = 500000
    training.snapshot_freq = 5000
    training.log_freq = 50
    training.eval_freq = 2500
    training.snapshot_freq_for_preemption = 5000
    training.likelihood_weighting = False
    training.continuous = arch == "ncsnv2"
    training.reduce_mean = False
    training.sde = "vesde"

    config.validation.batch_size = 500

    sampling = config.sampling
    sampling.method = "pc"
    sampling.predictor = "reverse_diffusion"
    sampling.corrector = "langevin"
    sampling.snr = 0.15

    evaluate = config.eval
    evaluate.begin_ckpt = 50
    evaluate.end_ckpt = 96
    evaluate.batch_size = 512

    data = config.data
    data.dataset = "CELEBA"
    data.image_size = 64
    data.effective_image_size = 64
    data.random_flip = False
    data.num_channels = 3
    data.shape = [3, 64, 64]

    model = config.model
    if arch == "ddpm":
        model.num_scales = 1000
        model.sigma_max = 320.0
        model.sigma_min = 0.01
        model.dropout = 0.1
        model.embedding_type = "fourier"
        model.name = "ddpm"
        model.scale_by_sigma = True
        model.ema_rate = 0.999
        model.normalization = "GroupNorm"
        model.nonlinearity = "swish"
        model.nf = 128
        model.ch_mult = (1, 1, 2)
        model.num_res_blocks = 2
        model.attn_resolutions = (16, 8, 4)
        model.resamp_with_conv = True
        model.conditional = True
        model.conv_size = 3
        model.input_channels = 3
        model.output_channels = 3
        config.optim.lr = 2e-4
        config.optim.warmup = 5000
    elif arch == "ncsn":
        model.name = "ncsn"
        model.scale_by_sigma = False
        model.sigma_max = 1.0
        model.num_scales = 10
        model.ema_rate = 0.0
        model.normalization = "InstanceNorm"
        model.nonlinearity = "elu"
        model.nf = 128
        model.interpolation = "bilinear"
        model.embedding_type = "fourier"
        model.dropout = 0.1
        _legacy_optim(config, 1e-3)
    elif arch == "ncsnv2":
        model.name = "ncsnv2_64"
        model.scale_by_sigma = True
        model.sigma_max = 90.0
        model.sigma_min = 0.01
        model.num_scales = 500
        model.ema_rate = 0.999
        model.normalization = "InstanceNorm++"
        model.nonlinearity = "elu"
        model.nf = 128
        model.interpolation = "bilinear"
        model.embedding_type = "fourier"
        model.dropout = 0.1
        _legacy_optim(config, 1e-4)
    else:
        raise ValueError(arch)
    return config
