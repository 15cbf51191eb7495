"""The CelebA-HQ super-resolution recipes of the paper's five conditional
estimators, copied from the JAX package's `configs/celeba_sr.py`: the
160px 8x flagship (`celeba_sr_160_config`), the 128px family
(`celeba_sr_128_config`), its nf=128 deep variant (`celeba_sr_deep_config`)
and the 64px 4x sigma_max_y sweep (`celeba_sr_interpolation_config`).

``approach`` is one of ``ours_NDV`` (CMDE), ``ours_DV`` (VS-CMDE: sigma_y
anneals during training), ``ours_slowDV`` (the slow anneal), ``song``
(CDiffE: y diffused as fast as x; spelled ``"Song"`` in
``training.conditioning_approach``) and ``sr3`` (CDE: one VE SDE on x,
`ddpm_paired_SR3` with 3 output channels; it carries the sigma_y fields
of the JAX recipe, which nothing reads: its task is ``conditional``).
"""

from __future__ import annotations

import math

from .base import Config, base_config

APPROACHES = ("ours_NDV", "ours_DV", "ours_slowDV", "song", "sr3")


def _check(approach: str) -> None:
    if approach not in APPROACHES:
        raise ValueError(f"approach {approach!r} unknown; one of {', '.join(APPROACHES)}")


def _root_numel(shape) -> float:
    return float(math.sqrt(math.prod(shape)))


def celeba_sr_160_config(approach: str = "ours_NDV") -> Config:
    _check(approach)
    config = base_config()

    training = config.training
    training.lightning_module = (
        "conditional_decreasing_variance" if approach in ("ours_DV", "ours_slowDV") else "conditional"
    )
    training.conditioning_approach = "Song" if approach == "song" else approach
    training.batch_size = 16
    training.workers = 4
    training.n_iters = 500000
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
    evaluate.snr = [0.15]
    # each estimator's test window
    if approach == "ours_DV":
        evaluate.draws = [2, 3, 4, 5]
        evaluate.first_test_batch, evaluate.last_test_batch, evaluate.batch_size = 47, 50, 100
    elif approach == "ours_slowDV":
        evaluate.draws = [1]
        evaluate.first_test_batch, evaluate.last_test_batch, evaluate.batch_size = 100, 200, 25
    elif approach == "song":
        evaluate.draws = [2, 3, 4, 5]
        evaluate.first_test_batch, evaluate.last_test_batch, evaluate.batch_size = 50, 75, 25
    else:
        evaluate.draws = [2, 3, 4, 5]
        evaluate.first_test_batch, evaluate.last_test_batch, evaluate.batch_size = 175, 200, 25

    data = config.data
    data.dataset = "celebA-HQ-160"
    data.task = "super-resolution"
    data.scale = 8
    data.mask_coverage = 0.25
    data.datamodule = "LRHR_PKLDataset"
    data.target_resolution = 160
    data.image_size = 160
    data.effective_image_size = 160
    data.shape_x = [3, 160, 160]
    data.shape_y = [3, 160, 160]
    data.use_flip = True
    data.use_crop = False
    data.use_rot = False
    data.upscale_lr = True
    data.num_channels = 6

    model = config.model
    model.num_scales = 1000
    model.sigma_max_x = _root_numel(data.shape_x)
    model.sigma_min_x = 5e-3
    model.sigma_min_y = 5e-3
    model.sigma_min_y_target = 5e-3
    if approach == "song":
        model.sigma_max_y = model.sigma_max_x
    elif approach == "ours_DV":
        model.sigma_max_y = _root_numel(data.shape_y)
        model.sigma_max_y_target = 0.5
        model.reach_target_steps = 250000
    elif approach == "ours_slowDV":
        model.sigma_max_y = _root_numel(data.shape_y)
        model.sigma_max_y_target = 1.0
        model.reach_target_steps = 500000
    elif approach == "sr3":
        model.sigma_min = model.sigma_min_x
        model.sigma_max = model.sigma_max_x
        model.sigma_max_y = _root_numel(data.shape_y)
        model.sigma_max_y_target = 0.5
        model.reach_target_steps = 250000
    else:  # ours_NDV
        model.sigma_max_y = 0.5
    model.dropout = 0.1
    model.embedding_type = "positional"
    model.name = "ddpm_paired_SR3" if approach == "sr3" else "ddpm_paired"
    model.ema_rate = 0.999
    model.nf = 96
    model.ch_mult = (1, 1, 2, 2, 3, 3)
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
    model.input_channels = 6
    model.output_channels = 3 if approach == "sr3" else 6

    config.optim.lr = 2e-4
    config.optim.warmup = 2500
    config.optim.grad_clip = 1.0
    return config


def celeba_sr_128_config(approach: str = "ours_NDV", *, smaxy: float | None = None) -> Config:
    """The 128px General_PKLDataset SR family (JAX
    `configs/celeba_sr.py:celeba_sr_128_config`); ``smaxy`` is CMDE's
    sigma_max_y, and the anneal's target for VS-CMDE and CDE."""
    config = celeba_sr_160_config(approach)
    config.training.batch_size = 25
    config.training.n_iters = 250000
    config.eval.batch_size = 25

    data = config.data
    data.datamodule = "General_PKLDataset"
    size = 128
    data.target_resolution = size
    data.image_size = size
    data.effective_image_size = size
    data.shape_x = [3, size, size]
    data.shape_y = [3, size, size]

    model = config.model
    model.sigma_max_x = _root_numel(data.shape_x)
    model.attn_resolutions = (16, 8, 4)
    if approach == "ours_NDV":
        model.sigma_max_y = 0.1 if smaxy is None else smaxy
    elif approach in ("ours_DV", "sr3"):
        model.sigma_max_y = _root_numel(data.shape_y)
        model.sigma_max_y_target = 0.1 if smaxy is None else smaxy
        model.reach_target_steps = 250000
    elif approach == "song":
        model.sigma_max_y = model.sigma_max_x
    return config


def celeba_sr_deep_config(approach: str = "ours_NDV") -> Config:
    """The deep (nf=128) 160px variants (JAX
    `configs/celeba_sr.py:celeba_sr_deep_config`)."""
    config = celeba_sr_160_config(approach)
    config.training.batch_size = 48

    evaluate = config.eval
    evaluate.draws = [1] if approach == "sr3" else [2]
    evaluate.first_test_batch = 0
    evaluate.last_test_batch = 100
    evaluate.batch_size = 50

    model = config.model
    model.nf = 128
    if approach == "ours_NDV":
        model.sigma_max_y = 0.3
    elif approach == "sr3":
        model.sigma_max_y_target = 0.3
        model.reach_target_steps = 250000
    return config


def celeba_sr_interpolation_config(approach: str = "ours_NDV", *, smaxy_log10: float = -1.0) -> Config:
    """The 64px scale-4 sigma_max_y interpolation sweep (JAX
    `configs/celeba_sr.py:celeba_sr_interpolation_config`; CMDE's
    sigma_max_y = 10^smaxy_log10).  As in JAX, only CMDE and CDE re-derive
    their sigma_y fields at 64px; the other approaches keep the 128px
    recipe's."""
    config = celeba_sr_128_config(approach)
    config.training.batch_size = 80
    config.training.n_iters = 500000
    config.eval.batch_size = 64

    data = config.data
    data.scale = 4
    size = 64
    data.target_resolution = size
    data.image_size = size
    data.effective_image_size = size
    data.shape_x = [3, size, size]
    data.shape_y = [3, size, size]

    model = config.model
    model.sigma_max_x = _root_numel(data.shape_x)
    model.ch_mult = (1, 1, 2, 2, 3)
    if approach == "ours_NDV":
        model.sigma_max_y = float(10.0**smaxy_log10)
    elif approach == "sr3":
        model.sigma_max_y = _root_numel(data.shape_y)
        model.sigma_max_y_target = 0.1
        model.reach_target_steps = 500000
    return config
