"""Convert the trained texture64 checkpoint's EMA into the PyTorch port's
EMA-only file.

    JAX_PLATFORMS=cpu python tests/_torch_port_convert_texture64.py

Restores `artifacts/texture64_run/texture64/checkpoints/40000` (an orbax
tree) as the JAX harness does (`eval/harness.py:_load_state`: `init_model`
-> `create_train_state` -> `CheckpointManager.restore`), converts
``state.ema.params`` with the port's `models/convert.py:flax_to_state_dict`
and writes ``{step, ema}`` in float32 to
`conditional_score_diffusion_tpu_torch/assets/texture64_sr_cmde_ema_40000.pt`
(`training/checkpoint.py:save_ema`).  The machine with the card has no JAX
or orbax, so the port reads this file there.  `tests/test_torch_texture64_ckpt.py`
holds the file against the checkpoint leaf by leaf.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

CHECKPOINTS = os.path.join(REPO, "artifacts", "texture64_run", "texture64", "checkpoints")


def restore_jax_state():
    """The JAX train state of the newest checkpoint, restored from the
    recipe `configs/artifacts/texture64_sr_cmde_test.py`."""
    from configs.artifacts.texture64_sr_cmde_test import get_config
    from conditional_score_diffusion_tpu.models import init_model
    from conditional_score_diffusion_tpu.training.checkpoint import CheckpointManager
    from conditional_score_diffusion_tpu.training.state import create_train_state

    config = get_config()
    _, params = init_model(config, jax.random.key(config.seed))
    mgr = CheckpointManager(CHECKPOINTS)
    try:
        return mgr.restore(create_train_state(config, params))
    finally:
        mgr.close()


def main() -> None:
    from conditional_score_diffusion_tpu_torch.configs.texture64_sr_cmde_test import EMA_ASSET
    from conditional_score_diffusion_tpu_torch.models.convert import flax_to_state_dict
    from conditional_score_diffusion_tpu_torch.training.checkpoint import save_ema

    state = restore_jax_state()
    ema = flax_to_state_dict(jax.device_get(state.ema.params))
    path = save_ema(EMA_ASSET, int(state.step), ema)
    n = sum(t.numel() for t in ema.values())
    print(f"step {int(state.step)}: {len(ema)} tensors, {n} floats -> {os.path.relpath(path, REPO)}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    main()
