"""The port's command line, with the flags of the JAX `main.py`:

    python -m conditional_score_diffusion_tpu_torch.main --mode train \\
        --config texture160_sr_cmde_conv3x3 [--log_path ./logs/] \\
        [--checkpoint_path DIR] [--data_path DIR] [--device cuda]

``--config`` is a recipe of `configs` by name (``texture160_sr_cmde_conv3x3``
for `configs.texture160_sr_cmde_conv3x3_config`) or the path of a Python
file whose ``get_config()`` returns a `configs.Config`.  ``--device`` (not a
JAX flag) is ``cuda`` unless the caller asks for the CPU.  Of the five JAX
modes only ``train`` is ported.
"""

from __future__ import annotations

import argparse
import importlib.util
import os

from . import configs

MODES = ["train", "test", "multi_scale_test", "compute_dataset_statistics", "evaluation_pipeline"]
NOT_PORTED = {
    "test": "the --mode test harness (ROADMAP.md section 1, item 2)",
    "multi_scale_test": "the Haar multi-scale chain (ROADMAP.md section 1, item 7)",
    "compute_dataset_statistics": "data/statistics.py (ROADMAP.md section 1, item 12)",
    "evaluation_pipeline": "eval/pipeline.py (ROADMAP.md section 1, item 2)",
}


def load_config(name: str):
    """A recipe by name, or from a file that defines ``get_config()``."""
    if name.endswith(".py") or os.path.sep in name:
        spec = importlib.util.spec_from_file_location("recipe", name)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.get_config()
    fn = getattr(configs, f"{name}_config", None)
    if fn is None:
        known = sorted(n[: -len("_config")] for n in configs.__all__ if n.endswith("_config"))
        raise KeyError(f"unknown recipe {name!r}; known: {', '.join(known)}")
    return fn()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", required=True, help="recipe name or get_config() file")
    parser.add_argument("--mode", required=True, choices=MODES)
    parser.add_argument("--checkpoint_path", default=None, help="checkpoint directory to resume from")
    parser.add_argument("--data_path", default=None, help="dataset location (overrides config.data.base_dir)")
    parser.add_argument("--log_path", default="./logs/", help="directory for logs and checkpoints")
    parser.add_argument("--eval_folder", default="eval", help="folder name for evaluation results")
    parser.add_argument("--device", default="cuda", help="torch device (cuda unless asked otherwise)")
    args = parser.parse_args(argv)

    config = load_config(args.config)
    if args.data_path is not None and "base_dir" in config.data:
        config.data.base_dir = args.data_path
    if args.mode != "train":
        raise NotImplementedError(f"--mode {args.mode} is not ported: it needs {NOT_PORTED[args.mode]}")
    from .training.trainer import train

    train(config, args.log_path, args.checkpoint_path, device=args.device)


if __name__ == "__main__":
    main()
