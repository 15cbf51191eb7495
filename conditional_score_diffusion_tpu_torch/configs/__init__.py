"""Recipes as plain Python (`Config` namespaces), without ml_collections."""

from .base import Config, base_config, image_model_defaults
from .celeba_sr import (
    celeba_sr_128_config,
    celeba_sr_160_config,
    celeba_sr_deep_config,
    celeba_sr_interpolation_config,
)
from .extra import (
    cifar10_vp_config,
    haar_conditional_config,
    haar_multiscale_unconditional_config,
    haarflow_config,
    mri_to_pet_config,
    texture160_unconditional_ncsnpp_config,
    texture64_haar_multiscale_unconditional_block_config,
    texture64_haar_multiscale_unconditional_config,
    unconditional_pkl_config,
)
from .inverse_problems import (
    inpainting_interpolation_config,
    i2i_interpolation_config,
    inverse_problem_config,
    texture160_colorization_cmde_block_config,
    texture160_inpainting_cmde_block_config,
    texture160_inpainting_cmde_config,
    texture64_i2i_cmde_block_config,
    texture_mri_to_pet_3d_config,
    texture_mri_to_pet_slices_block_config,
)
from .multiscale import (
    hq160_sequential_bicubic_master_config,
    hq160_sequential_haar_master_config,
    texture160_direct_8x_block_config,
    texture160_direct_8x_config,
    texture160_sequential_bicubic_master_block_config,
    texture160_sequential_bicubic_master_config,
    texture160_sequential_haar_master_block_config,
    texture160_sequential_haar_master_config,
    texture64_haar_scale_config,
    texture64_multiscale_master_block_config,
    texture64_multiscale_master_config,
)
from .score_sde import (
    texture128_ncsnv2_bedroom_config,
    texture32_ddpm_cifar10_vp_config,
    texture32_ncsn_cifar10_124_config,
    texture32_ncsnpp_cifar10_smld_config,
    texture64_ncsnv2_celeba_config,
)
from .srflow import (
    celeba_bicubic_config,
    celeba_haar_config,
    df2k_config,
    hq160_direct_8x_config,
    hq160_sequential_config,
)
from .texture160_kxsr_ncsnpp import get_config as texture160_kxsr_ncsnpp_config
from .texture160_kxsr_ncsnpp_block import get_config as texture160_kxsr_ncsnpp_block_config
from .texture160_sr import (
    texture160_sr_cde_config,
    texture160_sr_cdiffe_config,
    texture160_sr_vscmde_config,
    texture160_sr_vscmde_slow_config,
)
from .texture160_sr_cmde import get_config as texture160_sr_cmde_config
from .texture160_sr_cmde_bf16_block import get_config as texture160_sr_cmde_bf16_block_config
from .texture160_sr_cmde_conv3x3 import get_config as texture160_sr_cmde_conv3x3_config
from .texture64_sr_cmde import get_config as texture64_sr_cmde_config
from .texture64_sr_cmde_test import get_config as texture64_sr_cmde_test_config
from .texture64_sr_dv import get_config as texture64_sr_dv_config
from .toy import synthetic_config, toy_gaussian_bubbles_config, toy_vp_config

__all__ = [
    "Config",
    "base_config",
    "celeba_bicubic_config",
    "celeba_haar_config",
    "celeba_sr_128_config",
    "celeba_sr_160_config",
    "celeba_sr_deep_config",
    "celeba_sr_interpolation_config",
    "cifar10_vp_config",
    "df2k_config",
    "haar_conditional_config",
    "haar_multiscale_unconditional_config",
    "haarflow_config",
    "hq160_direct_8x_config",
    "hq160_sequential_bicubic_master_config",
    "hq160_sequential_config",
    "hq160_sequential_haar_master_config",
    "i2i_interpolation_config",
    "image_model_defaults",
    "inpainting_interpolation_config",
    "inverse_problem_config",
    "mri_to_pet_config",
    "synthetic_config",
    "texture128_ncsnv2_bedroom_config",
    "texture160_colorization_cmde_block_config",
    "texture160_direct_8x_block_config",
    "texture160_direct_8x_config",
    "texture160_inpainting_cmde_block_config",
    "texture160_inpainting_cmde_config",
    "texture160_kxsr_ncsnpp_block_config",
    "texture160_kxsr_ncsnpp_config",
    "texture160_sequential_bicubic_master_block_config",
    "texture160_sequential_bicubic_master_config",
    "texture160_sequential_haar_master_block_config",
    "texture160_sequential_haar_master_config",
    "texture160_sr_cde_config",
    "texture160_sr_cdiffe_config",
    "texture160_sr_cmde_bf16_block_config",
    "texture160_sr_cmde_config",
    "texture160_sr_cmde_conv3x3_config",
    "texture160_sr_vscmde_config",
    "texture160_sr_vscmde_slow_config",
    "texture160_unconditional_ncsnpp_config",
    "texture32_ddpm_cifar10_vp_config",
    "texture32_ncsn_cifar10_124_config",
    "texture32_ncsnpp_cifar10_smld_config",
    "texture64_haar_multiscale_unconditional_block_config",
    "texture64_haar_multiscale_unconditional_config",
    "texture64_haar_scale_config",
    "texture64_i2i_cmde_block_config",
    "texture64_multiscale_master_block_config",
    "texture64_multiscale_master_config",
    "texture64_ncsnv2_celeba_config",
    "texture64_sr_cmde_config",
    "texture64_sr_cmde_test_config",
    "texture64_sr_dv_config",
    "texture_mri_to_pet_3d_config",
    "texture_mri_to_pet_slices_block_config",
    "toy_gaussian_bubbles_config",
    "toy_vp_config",
    "unconditional_pkl_config",
]
