"""The score_sde, Haar-flow and SRFlow recipe files by path: each file of
the JAX package's `configs/ve/`, `configs/vp/` and `configs/subvp/` trees
(but `configs/ve/inverse_problems/`, which `configs/inverse_problems.py`
tables), copied into :data:`RECIPES` (key: the path from ``configs/``,
without ``.py``), so ``--config configs/ve/ncsnv2/celeba.py`` names the
same recipe in the port's CLI as in JAX's.  They build on
`configs/song.py`, `configs/ncsn_legacy.py`, `configs/extra.py` and
`configs/srflow.py`.  A ``master_config`` file is a master `Config` of its
scales' recipes (keys ``config_*``, as the JAX file's), with no
``coordinate_space``, as in JAX: ``--mode multi_scale_test`` then chains
it in the ``haar`` space (ROADMAP.md section 3, hazards).

Then the texture twins of five of them: the recipe at its own widths, its
data a PNG folder written from the committed texture64 / texture160 sets
(`write_twin_folder`), for the card.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict

import numpy as np

from .base import Config, base_config
from .extra import (
    cifar10_vp_config,
    haar_conditional_config,
    haar_multiscale_unconditional_config,
    haarflow_config,
    mri_to_pet_config,
    unconditional_pkl_config,
)
from .inverse_problems import path_key
from .ncsn_legacy import jan_celeba64_config, ncsn_config, ncsnv2_config
from .song import ddpm_block, ddpmpp_block, ffhq_1024_config, get_default_configs, ncsnpp_block, ncsnpp_lsun_block
from .srflow import (
    celeba_bicubic_config,
    celeba_haar_config,
    df2k_config,
    hq160_direct_8x_config,
    hq160_sequential_config,
)
from .toy import synthetic_config


def _ve(dataset: str, continuous: bool) -> Config:
    config = get_default_configs(dataset)
    config.training.sde = "vesde"
    config.training.continuous = continuous
    return config


def _vp(dataset: str, sde: str, continuous: bool, predictor: str, reduce_mean: bool = True) -> Config:
    """The VP / sub-VP CIFAR-10 / LSUN preamble: centred data, no corrector."""
    config = get_default_configs(dataset)
    config.training.sde = sde
    config.training.continuous = continuous
    config.training.reduce_mean = reduce_mean
    config.sampling.predictor = predictor
    config.sampling.corrector = "none"
    config.data.centered = True
    return config


def _resize(config: Config, dataset: str, size: int) -> Config:
    data = config.data
    data.dataset = dataset
    data.image_size = data.effective_image_size = size
    data.shape = [3, size, size]
    return config


# ---- configs/ve -------------------------------------------------------------


def ve_lsun_ncsnpp(category: str = None, dataset: str = None, size: int = None, sigma_max: float = None) -> Config:
    """`bedroom_`, `church_`, `celebahq_256_` and `ffhq_256_ncsnpp_continuous`."""
    config = _ve("lsun", True)
    if category is not None:
        config.data.category = category
    if dataset is not None:
        _resize(config, dataset, size)
    ncsnpp_lsun_block(config.model)
    if sigma_max is not None:
        config.model.sigma_max = sigma_max
    return config


def ve_celeba_ncsnpp() -> Config:
    config = _ve("celeba", False)
    ncsnpp_block(config.model)
    config.model.sigma_begin = 90
    config.model.embedding_type = "positional"
    return config


def ve_cifar10_ddpm() -> Config:
    config = _ve("cifar10", False)
    ddpm_block(config.model)
    return config


def ve_cifar10_ncsnpp() -> Config:
    """The discrete-VE (SMLD) NCSN++ on CIFAR-10."""
    config = _ve("cifar10", False)
    ncsnpp_block(config.model)
    config.model.embedding_type = "positional"
    return config


def ve_cifar10_ncsnpp_deep_continuous() -> Config:
    config = _ve("cifar10", True)
    config.training.n_iters = 950001
    ncsnpp_block(config.model, deep=True)
    return config


def ve_cifar10_ncsnpp_continuous() -> Config:
    """The file spells the CIFAR-10 defaults out on `base_config`."""
    config = base_config()
    training = config.training
    training.batch_size = 128
    training.n_iters = 1300001
    training.snapshot_freq = 50000
    training.log_freq = 50
    training.eval_freq = 100
    training.likelihood_weighting = False
    training.continuous = True
    training.reduce_mean = False
    training.sde = "vesde"
    sampling = config.sampling
    sampling.method = "pc"
    sampling.predictor = "reverse_diffusion"
    sampling.corrector = "langevin"
    sampling.snr = 0.16
    config.eval.batch_size = 1024
    data = config.data
    data.dataset = "CIFAR10"
    data.datamodule = "image"
    data.image_size = 32
    data.effective_image_size = 32
    data.random_flip = True
    data.centered = False
    data.num_channels = 3
    data.shape = [3, 32, 32]
    model = config.model
    model.sigma_min = 0.01
    model.sigma_max = 50.0
    model.num_scales = 1000
    model.dropout = 0.1
    model.embedding_type = "fourier"
    ncsnpp_block(model)  # the file's model fields (the four it leaves alone equal their defaults)
    config.optim.warmup = 5000
    return config


# ---- configs/vp and configs/subvp -------------------------------------------


def vp_cifar10_ddpmpp() -> Config:
    config = _vp("cifar10", "vpsde", False, "ancestral_sampling")
    ddpmpp_block(config.model)
    return config


def vp_cifar10_ncsnpp(sde: str = "vpsde", continuous: bool = False, deep: bool = False) -> Config:
    """DDPM++ with FIR and the residual input pyramid (`cifar10_ncsnpp*`);
    the discrete file samples with reverse diffusion, the continuous ones
    with Euler-Maruyama."""
    config = _vp("cifar10", sde, continuous, "euler_maruyama" if continuous else "reverse_diffusion")
    if deep:
        config.training.n_iters = 950001
    ddpmpp_block(config.model, deep=deep)
    config.model.fir = True
    config.model.progressive_input = "residual"
    return config


def vp_cifar10_ddpmpp_deep_continuous(sde: str = "vpsde") -> Config:
    config = _vp("cifar10", sde, True, "euler_maruyama")
    config.training.n_iters = 950001
    ddpmpp_block(config.model, deep=True)
    return config


def subvp_cifar10_ddpmpp_continuous() -> Config:
    config = _vp("cifar10", "subvpsde", True, "euler_maruyama")
    ddpmpp_block(config.model)
    return config


def vp_ddpm(dataset: str = "cifar10", sde: str = "vpsde", continuous: bool = False, conditional: bool = True,
            category: str = None, size_dataset: str = None) -> Config:
    """The DDPM U-Net under VP / sub-VP (`configs/vp/ddpm/*`,
    `configs/subvp/cifar10_ddpm_continuous.py`); LSUN-size files take
    ch_mult (1, 1, 2, 2, 4, 4) and lr 2e-5."""
    lsun = dataset == "lsun"
    config = _vp(dataset, sde, continuous, "euler_maruyama" if continuous else "ancestral_sampling")
    if category is not None:
        config.data.category = category
    if size_dataset is not None:
        _resize(config, size_dataset, 256)
    model = config.model
    ddpm_block(model)
    model.scale_by_sigma = False
    model.ema_rate = 0.9999
    if not conditional:
        model.conditional = False
    if lsun:
        model.num_scales = 1000
        model.ch_mult = (1, 1, 2, 2, 4, 4)
        config.optim.lr = 2e-5
    return config


def vp_synthetic_higher_lr() -> Config:
    config = synthetic_config(sde="vpsde")
    config.model.beta_max = 25
    config.optim.lr = 2e-5
    return config


def vp_toy_moons() -> Config:
    config = synthetic_config(sde="vpsde")
    config.training.num_epochs = 10
    config.training.n_iters = 10000
    config.data.dataset_type = "Moons"
    config.data.noise_scale = 0.015
    config.model.sigma_max = 378
    config.model.beta_max = 25
    config.optim.lr = 2e-5
    return config


def vp_unconditional_generation_celeba() -> Config:
    config = unconditional_pkl_config(128)
    training = config.training
    training.sde = "vpsde"
    training.n_iters = 2400001
    training.likelihood_weighting = True
    training.reduce_mean = True
    sampling = config.sampling
    sampling.predictor = "ancestral_sampling"
    sampling.corrector = "none"
    sampling.snr = 0.15
    model = config.model
    model.sigma_min = 0.01
    model.name = "ddpm"
    model.scale_by_sigma = False
    model.num_scales = 1000
    model.ema_rate = 0.9999
    model.nf = 128
    model.ch_mult = (1, 1, 2, 2, 4)
    model.num_res_blocks = 2
    model.attn_resolutions = (16,)
    model.dropout = 0.0
    model.embedding_type = "fourier"
    model.input_channels = 3
    model.output_channels = 3
    config.optim.warmup = 5000
    return config


def vp_mri_to_pet_sr3() -> Config:
    """The SR3 MRI->PET slices under the VP SDE."""
    config = mri_to_pet_config(volumetric=False, approach="sr3")
    config.experiment_name = "vp_da"
    config.training.sde = "vpsde"
    return config


def _recipes() -> Dict[str, Callable[[], Config]]:
    table = {
        "ve/SyntheticDataset": lambda: synthetic_config(sde="vesde"),
        "ve/bedroom_ncsnpp_continuous": lambda: ve_lsun_ncsnpp(category="bedroom"),
        "ve/church_ncsnpp_continuous": lambda: ve_lsun_ncsnpp(category="church_outdoor", sigma_max=380.0),
        "ve/celebahq_256_ncsnpp_continuous": lambda: ve_lsun_ncsnpp(dataset="CelebAHQ", size=256, sigma_max=348.0),
        "ve/ffhq_256_ncsnpp_continuous": lambda: ve_lsun_ncsnpp(dataset="FFHQ", size=256, sigma_max=348.0),
        "ve/celebahq_ncsnpp_continuous": lambda: ffhq_1024_config("CelebAHQ"),
        "ve/ffhq_ncsnpp_continuous": lambda: ffhq_1024_config("FFHQ"),
        "ve/celeba_ncsnpp": ve_celeba_ncsnpp,
        "ve/cifar10_ddpm": ve_cifar10_ddpm,
        "ve/cifar10_ncsnpp": ve_cifar10_ncsnpp,
        "ve/cifar10_ncsnpp_continuous": ve_cifar10_ncsnpp_continuous,
        "ve/cifar10_ncsnpp_deep_continuous": ve_cifar10_ncsnpp_deep_continuous,
        "ve/ncsnv2/bedroom": lambda: ncsnv2_config("bedroom"),
        "ve/ncsnv2/celeba": lambda: ncsnv2_config("celeba"),
        "ve/ncsnv2/cifar10": lambda: ncsnv2_config("cifar10"),
        "vp/SyntheticDataset": lambda: synthetic_config(sde="vpsde"),
        "vp/SyntheticDataset_higher_lr": vp_synthetic_higher_lr,
        "vp/toy_moons": vp_toy_moons,
        "vp/unconditional_generation_celebA": vp_unconditional_generation_celeba,
        "vp/inverse_problems/MRI_to_PET/mri_to_pet_SR3": vp_mri_to_pet_sr3,
        "vp/cifar10_ddpmpp": vp_cifar10_ddpmpp,
        "vp/cifar10_ddpmpp_continuous": lambda: cifar10_vp_config("vpsde"),
        "vp/cifar10_ddpmpp_deep_continuous": vp_cifar10_ddpmpp_deep_continuous,
        "vp/cifar10_ncsnpp": vp_cifar10_ncsnpp,
        "vp/cifar10_ncsnpp_continuous": lambda: vp_cifar10_ncsnpp(continuous=True),
        "vp/cifar10_ncsnpp_deep_continuous": lambda: vp_cifar10_ncsnpp(continuous=True, deep=True),
        "vp/ddpm/cifar10": vp_ddpm,
        "vp/ddpm/cifar10_continuous": lambda: vp_ddpm(continuous=True),
        "vp/ddpm/cifar10_unconditional": lambda: vp_ddpm(conditional=False),
        "vp/ddpm/bedroom": lambda: vp_ddpm("lsun", category="bedroom"),
        "vp/ddpm/church": lambda: vp_ddpm("lsun", category="church_outdoor"),
        "vp/ddpm/celebahq": lambda: vp_ddpm("lsun", size_dataset="CelebAHQ"),
        "subvp/cifar10_ddpm_continuous": lambda: vp_ddpm(sde="subvpsde", continuous=True),
        "subvp/cifar10_ddpmpp_continuous": subvp_cifar10_ddpmpp_continuous,
        "subvp/cifar10_ddpmpp_deep_continuous": lambda: vp_cifar10_ddpmpp_deep_continuous("subvpsde"),
        "subvp/cifar10_ncsnpp_continuous": lambda: cifar10_vp_config("subvpsde"),
        "subvp/cifar10_ncsnpp_deep_continuous": lambda: vp_cifar10_ncsnpp("subvpsde", continuous=True, deep=True),
    }
    for dataset in ("cifar10", "celeba"):
        for variant, suffix in (("v1", ""), ("124", "_124"), ("1245", "_1245"), ("5", "_5")):
            table[f"ve/ncsn/{dataset}{suffix}"] = lambda d=dataset, v=variant: ncsn_config(d, v)
    for arch in ("ddpm", "ncsn", "ncsnv2"):
        table[f"ve/jan/{arch}/celeba_64"] = lambda a=arch: jan_celeba64_config(a)
    for stem, size in (("celebA-HQ-128", 128), ("celebA-HQ-64", 64), ("celebA_HQ_128", 128), ("celebA_HQ_64", 64)):
        table[f"ve/unconditional/{stem}"] = lambda s=size: unconditional_pkl_config(s)
    table.update(_haarflow_and_srflow())
    return table


def _master(build: Callable[[int], Config], sizes) -> Config:
    """A ``master_config`` file: its scales' recipes under ``config_{size}``."""
    return Config(**{f"config_{size}": build(size) for size in sizes})


def _haarflow_and_srflow() -> Dict[str, Callable[[], Config]]:
    """`configs/ve/haarflow/`, `configs/vp/haarflow/` and `configs/ve/srflow/`."""
    table = {
        "ve/haarflow/128": lambda: haarflow_config(128, "vesde"),
        "ve/haarflow/haar_128": lambda: haar_conditional_config(128, 256),
        "ve/haarflow/haar_multiscale_unconditional_64": lambda: haar_multiscale_unconditional_config(64),
        "vp/haarflow/celebahq": lambda: haarflow_config(64, "vpsde"),
        "ve/srflow/DF2K/direct/4x": lambda: df2k_config("direct"),
        "ve/srflow/DF2K/sequential/40to80": lambda: df2k_config("40to80"),
        "ve/srflow/DF2K/sequential/80to160": lambda: df2k_config("80to160"),
        "ve/srflow/celebA/bicubic/reduce_both_min_and_max/config_80":
            lambda: celeba_bicubic_config(80, reduce_both=True),
        "ve/srflow/celebA/bicubic/reduce_max_only/master_config": lambda: _master(celeba_bicubic_config, (40, 80, 160)),
        "ve/srflow/celebA/haar/master_config": lambda: _master(celeba_haar_config, (80, 160)),
        "ve/srflow/celebAHQ160/direct/8x": hq160_direct_8x_config,
    }
    for size in (40, 80, 160):
        table[f"ve/srflow/celebA/bicubic/reduce_max_only/config_{size}"] = lambda s=size: celeba_bicubic_config(s)
        table[f"ve/srflow/celebA/haar/config_{size}"] = lambda s=size: celeba_haar_config(s)
    for space in ("bicubic", "haar"):
        stem = f"ve/srflow/celebAHQ160/sequential/{space}"
        table[f"{stem}/master_config"] = lambda sp=space: _master(
            lambda s: hq160_sequential_config(s, sp), (40, 80, 160))
        for size in (40, 80, 160):
            table[f"{stem}/config_{size}"] = lambda s=size, sp=space: hq160_sequential_config(s, sp)
    return table


#: recipe file path (from ``configs/``, without ``.py``) -> the call that builds it
RECIPES = _recipes()


def recipe_key(name: str):
    """The :data:`RECIPES` key ``name`` names (a key, or the path of its
    file), else None."""
    key = path_key(name)
    return key if key in RECIPES else None


# ---- the texture twins -------------------------------------------------------

TWIN_DIR = os.path.join("logs", "texture_score_sde")
TEXTURE64_FOLDER, TEXTURE128_FOLDER = "texture64_flat", "texture128_flat"
TEXTURE64_IMAGES = 1280  # the first 1,280 texture64 train images: 1,024 / 128 / 128 by data.split


def write_twin_folders(base_dir: str = TWIN_DIR, source_dir: str = "datasets") -> str:
    """The twins' flat PNG folders under ``base_dir``: ``texture64_flat``,
    the first 1,280 texture64 train images (64px), and ``texture128_flat``,
    the texture160 train images bicubic-resized to 128px once, here
    (`ops.resize.imresize`, torch's matmuls on the CPU), so the 128px
    twin's host batches are read, not resized.  PNGs at zlib level 1: the
    same pixels, written ~3x faster.  Returns ``base_dir``."""
    import torch
    from PIL import Image

    from ..data.pkl_datasets import load_pkl_images
    from ..ops.resize import imresize

    def write(folder, images):
        path = os.path.join(base_dir, folder)
        os.makedirs(path, exist_ok=True)
        with ThreadPoolExecutor(8) as pool:  # zlib and the file writes release the GIL
            list(pool.map(lambda i: Image.fromarray(images[i]).save(os.path.join(path, f"{i:05d}.png"),
                                                                    compress_level=1), range(len(images))))

    write(TEXTURE64_FOLDER, load_pkl_images(os.path.join(source_dir, "texture64", "texture64-train.pklv4"),
                                            TEXTURE64_IMAGES))
    big = np.stack(load_pkl_images(os.path.join(source_dir, "texture160", "texture160-train.pklv4")))
    small = imresize(torch.from_numpy(big).float() / 255.0, out_shape=(128, 128)).numpy()
    write(TEXTURE128_FOLDER, np.clip(np.round(small * 255.0), 0, 255).astype(np.uint8))
    return base_dir


def _twin(config: Config, folder: str, base_dir: str) -> Config:
    config.data.dataset = folder
    config.data.base_dir = base_dir
    return config


def texture64_ncsnv2_celeba_config(base_dir: str = TWIN_DIR) -> Config:
    """`configs/ve/ncsnv2/celeba.py` (ncsnv2_64, nf 128, 64px, 500 levels to
    sigma 90, ALD 5 x snr 0.128, B=128) on the texture64 folder."""
    return _twin(ncsnv2_config("celeba"), TEXTURE64_FOLDER, base_dir)


def texture128_ncsnv2_bedroom_config(base_dir: str = TWIN_DIR) -> Config:
    """`configs/ve/ncsnv2/bedroom.py` (ncsnv2_128, nf 128, 128px, 1086
    levels to sigma 190, ALD 3 x snr 0.095, B=128) on the 128px folder."""
    return _twin(ncsnv2_config("bedroom"), TEXTURE128_FOLDER, base_dir)


def texture32_ncsn_cifar10_124_config(base_dir: str = TWIN_DIR) -> Config:
    """`configs/ve/ncsn/cifar10_124.py` (ncsn, nf 128, 32px, 232 classes,
    ALD 5 x snr 0.176, B=128) on the texture64 folder, which the datamodule
    resizes to 32px."""
    return _twin(ncsn_config("cifar10", "124"), TEXTURE64_FOLDER, base_dir)


def texture32_ncsnpp_cifar10_smld_config(base_dir: str = TWIN_DIR) -> Config:
    """`configs/ve/cifar10_ncsnpp.py`: the discrete-VE NCSN++ (nf 128, FIR,
    the residual input pyramid, positional embedding; reverse diffusion +
    Langevin) on the texture64 folder at 32px."""
    return _twin(ve_cifar10_ncsnpp(), TEXTURE64_FOLDER, base_dir)


def texture32_ddpm_cifar10_vp_config(base_dir: str = TWIN_DIR) -> Config:
    """`configs/vp/ddpm/cifar10.py`: the DDPM U-Net on the discrete VP SDE
    (the epsilon loss; ancestral sampling) on the texture64 folder at 32px."""
    return _twin(vp_ddpm(), TEXTURE64_FOLDER, base_dir)
