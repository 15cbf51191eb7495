"""Shared config defaults, copied from the JAX package's `configs/base.py`.

Field names and values are the JAX package's, so code written against its
recipes reads these unchanged.  A recipe is a tree of :class:`Config`
namespaces instead of an ml_collections ConfigDict.
"""

from __future__ import annotations

import types
from typing import Any


class Config(types.SimpleNamespace):
    """Attribute namespace with the two ConfigDict methods the port reads:
    ``key in config`` and ``config.get(key, default)``."""

    def __contains__(self, key: str) -> bool:
        return key in self.__dict__

    def get(self, key: str, default: Any = None) -> Any:
        return self.__dict__.get(key, default)


def base_config() -> Config:
    training = Config(
        lightning_module="base",
        batch_size=128,
        num_nodes=1,
        gpus=1,
        accelerator=None,
        accumulate_grad_batches=1,
        workers=4,
        num_epochs=10000,
        n_iters=500000,
        snapshot_freq=5000,
        log_freq=250,
        eval_freq=2500,
        visualization_callback="base",
        visualization_freq=0,  # 0 -> follow snapshot_freq
        show_evolution=False,
        likelihood_weighting=True,
        continuous=True,
        reduce_mean=True,
        sde="vesde",
        snapshot_freq_for_preemption=5000,
        snapshot_sampling=True,
    )
    sampling = Config(
        method="pc",
        predictor="reverse_diffusion",
        corrector="langevin",
        n_steps_each=1,
        noise_removal=True,
        probability_flow=False,
        snr=0.15,
        use_path=False,
    )
    evaluate = Config(
        workers=4,
        batch_size=64,
        callback="base",
        evaluation_metrics=["lpips", "psnr", "ssim", "consistency", "diversity"],
        predictor="default",
        corrector="default",
        p_steps="default",
        c_steps="default",
        snr=[0.15],
        denoise=True,
        use_path=False,
        draws=[2],
        save_samples=True,
        first_test_batch=0,
        last_test_batch=1,
        base_log_dir="evaluation",
        begin_ckpt=50,
        end_ckpt=96,
        enable_sampling=True,
        num_samples=50000,
        enable_loss=True,
        enable_bpd=False,
        bpd_dataset="test",
        max_val_batches=0,  # 0 -> evaluate the full validation split
    )
    validation = Config(batch_size=128, workers=4)
    data = Config(
        base_dir="datasets",
        dataset="",
        datamodule="",
        use_data_mean=False,
        create_dataset=False,
        split=[0.8, 0.1, 0.1],
        centered=False,
        uniform_dequantization=False,
    )
    model = Config(
        checkpoint_path="",
        num_scales=1000,
        sigma_min=0.01,
        sigma_max=50.0,
        beta_min=0.1,
        beta_max=20.0,
        dropout=0.1,
        embedding_type="positional",
        name="",
        scale_by_sigma=True,
        ema_rate=0.999,
        normalization="GroupNorm",
        nonlinearity="swish",
    )
    optim = Config(
        weight_decay=0,
        optimizer="Adam",
        lr=2e-4,
        beta1=0.9,
        eps=1e-8,
        warmup=2500,
        grad_clip=1.0,
    )
    return Config(
        training=training,
        sampling=sampling,
        eval=evaluate,
        validation=validation,
        data=data,
        model=model,
        optim=optim,
        seed=42,
    )


def image_model_defaults(model: Config) -> Config:
    """NCSN++/DDPM U-Net defaults shared by every image recipe."""
    model.nf = 128
    model.ch_mult = (1, 2, 2, 2)
    model.num_res_blocks = 2
    model.attn_resolutions = (16,)
    model.resamp_with_conv = True
    model.conditional = True
    model.fir = True
    model.fir_kernel = [1, 3, 3, 1]
    model.skip_rescale = True
    model.resblock_type = "biggan"
    model.progressive = "none"
    model.progressive_input = "none"
    model.progressive_combine = "sum"
    model.attention_type = "ddpm"
    model.init_scale = 0.0
    model.fourier_scale = 16
    model.conv_size = 3
    return model
