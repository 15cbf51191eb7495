"""Convert the trained texture64 Haar pyramid's two checkpoints into the
PyTorch port's EMA-only files.

    JAX_PLATFORMS=cpu python tests/_torch_port_convert_texture64_pyramid.py

Restores each scale of `configs/artifacts/texture64_multiscale_master.py` as
the JAX chain does (`eval/multiscale.py:_load_scale`: `init_model` ->
`create_train_state` -> `CheckpointManager.restore` at `latest_step()`,
14000 for scale_32 and 12000 for scale_64), converts ``state.ema.params``
with the port's `models/convert.py:flax_to_state_dict` and writes
``{step, ema}`` in float32 to
`conditional_score_diffusion_tpu_torch/assets/texture64_pyramid_scale{32,64}_ema.pt`
(`training/checkpoint.py:save_ema`).  The machine with the card has no JAX
or orbax, so the port reads these files there.
`tests/test_torch_texture64_pyramid_ckpt.py` holds them against the
checkpoints leaf by leaf.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

SIZES = (32, 64)


def checkpoint_dir(image_size: int) -> str:
    return os.path.join(REPO, "artifacts", "texture64_pyramid", f"scale_{image_size}", "texture64", "checkpoints")


def restore_jax_state(image_size: int):
    """The JAX train state of the scale's newest checkpoint."""
    from configs.artifacts.texture64_haar_scales import scale_config
    from conditional_score_diffusion_tpu.models import init_model
    from conditional_score_diffusion_tpu.training.checkpoint import CheckpointManager
    from conditional_score_diffusion_tpu.training.state import create_train_state

    config = scale_config(image_size)
    _, params = init_model(config, jax.random.key(config.seed))
    mgr = CheckpointManager(checkpoint_dir(image_size))
    try:
        return mgr.restore(create_train_state(config, params))
    finally:
        mgr.close()


def main() -> None:
    from conditional_score_diffusion_tpu_torch.configs.multiscale import pyramid_ema_asset
    from conditional_score_diffusion_tpu_torch.models.convert import flax_to_state_dict
    from conditional_score_diffusion_tpu_torch.training.checkpoint import save_ema

    for size in SIZES:
        state = restore_jax_state(size)
        ema = flax_to_state_dict(jax.device_get(state.ema.params))
        path = save_ema(pyramid_ema_asset(size), int(state.step), ema)
        n = sum(t.numel() for t in ema.values())
        print(f"scale {size}, step {int(state.step)}: {len(ema)} tensors, {n} floats -> {os.path.relpath(path, REPO)}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    main()
