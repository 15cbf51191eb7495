"""The 2-D GaussianBubbles toy recipes (FCN score network, `Synthetic`
datamodule), copied: `synthetic_config` and `toy_vp_config` from the JAX
package's `configs/extra.py`, and `toy_gaussian_bubbles_config` from the
repo's `configs/toy_gaussian_bubbles.py` (the fastest end-to-end training
recipe: 10,000 steps of batch 256, VE, the ``2D`` callback every 2,000
steps)."""

from __future__ import annotations

from .base import Config, base_config


def _bubbles(config: Config, data_samples: int) -> Config:
    data = config.data
    data.datamodule = "Synthetic"
    data.dataset = "Synthetic"
    data.dataset_type = "GaussianBubbles"
    data.data_samples = data_samples
    data.mixtures = 4
    data.return_mixtures = False
    data.shape = [2]
    return config


def toy_vp_config() -> Config:
    """2-D GaussianBubbles with a VP SDE (JAX `configs/extra.py:toy_vp_config`)."""
    config = _bubbles(base_config(), 100000)
    config.training.sde = "vpsde"
    config.training.batch_size = 256
    model = config.model
    model.name = "fcn"
    model.state_size = 2
    model.hidden_layers = 2
    model.hidden_nodes = 128
    model.dropout = 0.0
    model.num_scales = 500
    config.optim.lr = 1e-3
    return config


def synthetic_config(sde: str = "vesde") -> Config:
    """2-D GaussianBubbles with the reference's hyperparameters (JAX
    `configs/extra.py:synthetic_config`): batch 500, FCN 3x64, dropout 0.25,
    1000 scales, EMA 0.9999."""
    config = base_config()
    training = config.training
    training.sde = sde
    training.batch_size = 500
    training.workers = 4
    training.num_epochs = 10000
    training.n_iters = 500000
    training.snapshot_freq = 5000
    training.log_freq = 50
    training.eval_freq = 2500
    training.likelihood_weighting = False
    training.continuous = True
    training.reduce_mean = False
    training.visualization_callback = "2D"

    sampling = config.sampling
    sampling.method = "pc"
    sampling.predictor = "reverse_diffusion"
    sampling.corrector = "none"
    sampling.snr = 0.075

    config.validation.batch_size = 500
    config.eval.batch_size = 512

    data = _bubbles(config, 50000).data
    data.dim = 2
    data.num_channels = 0

    model = config.model
    model.sigma_max = 4 if sde == "vesde" else 378
    model.sigma_min = 0.01
    model.beta_min = 0.1
    model.beta_max = 25 if sde == "vesde" else 20
    model.name = "fcn"
    model.state_size = 2
    model.hidden_layers = 3
    model.hidden_nodes = 64
    model.dropout = 0.25
    model.scale_by_sigma = False
    model.num_scales = 1000
    model.ema_rate = 0.9999

    optim = config.optim
    optim.lr = 2e-5 if sde == "vesde" else 1e-4
    optim.warmup = 5000
    return config


def toy_gaussian_bubbles_config() -> Config:
    """FCN + VE on GaussianBubbles (`configs/toy_gaussian_bubbles.py`)."""
    config = _bubbles(base_config(), 100000)
    training = config.training
    training.batch_size = 256
    training.n_iters = 10000
    training.log_freq = 100
    training.eval_freq = 1000
    training.snapshot_freq = 2000
    training.visualization_callback = "2D"

    model = config.model
    model.name = "fcn"
    model.state_size = 2
    model.hidden_layers = 2
    model.hidden_nodes = 128
    model.dropout = 0.0
    model.sigma_min = 0.01
    model.sigma_max = 2.0
    model.num_scales = 500

    config.optim.lr = 1e-3
    config.optim.warmup = 100
    config.sampling.snr = 0.15
    return config
