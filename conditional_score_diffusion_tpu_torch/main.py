"""The port's command line, with the flags of the JAX `main.py`:

    python -m conditional_score_diffusion_tpu_torch.main --mode train \\
        --config texture160_sr_cmde_conv3x3 [--log_path ./logs/] \\
        [--checkpoint_path DIR] [--data_path DIR] [--device cuda]
    python -m conditional_score_diffusion_tpu_torch.main --mode test \\
        --config texture64_sr_cmde_test [--checkpoint_path FILE_OR_DIR]
    python -m conditional_score_diffusion_tpu_torch.main \\
        --mode evaluation_pipeline --config texture64_sr_cmde_test
    python -m conditional_score_diffusion_tpu_torch.main \\
        --mode multi_scale_test --config texture64_multiscale_master
    python -m conditional_score_diffusion_tpu_torch.main \\
        --mode compute_dataset_statistics --config texture64_sr_cmde

``--config`` is a recipe of `configs` by name (``texture160_sr_cmde_conv3x3``
for `configs.texture160_sr_cmde_conv3x3_config`), the path of a JAX recipe
file that `configs.inverse_problems.RECIPES` or `configs.score_sde.RECIPES`
copies (``configs/ve/inverse_problems/inpainting/celebA_ours_NDV.py``,
``configs/ve/ncsnv2/celeba.py``; read from the table, not the file) or the
path of a Python file whose
``get_config()`` returns a `configs.Config`; for
``evaluation_pipeline`` it may also be a master config (a `Config` of leaf
recipes, JAX `run_lib.py:evaluation_pipeline`), and for
``multi_scale_test`` it is one (per-scale recipes and a
``coordinate_space``, `configs/multiscale.py`; the chain's PNGs and
``metrics.json`` go under ``{log_path}/multi_scale``).
``compute_dataset_statistics`` writes the mean of the train split's Haar
detail coefficients (`data.statistics`).  ``--device`` (not a JAX flag) is
``cuda`` unless the caller asks for the CPU.

Data parallel, one process per card (`parallel`; JAX's ``('data',)`` mesh):

    torchrun --standalone --nproc_per_node=N -m conditional_score_diffusion_tpu_torch.main \
        --mode train --config texture160_sr_cmde_conv3x3 --log_path <dir>
    torchrun --standalone --nproc_per_node=N -m conditional_score_diffusion_tpu_torch.main \
        --mode test --config texture64_sr_cmde_test

With ``WORLD_SIZE`` > 1 each process joins the group (NCCL on
``cuda:LOCAL_RANK``, gloo on the CPU) and leaves it at the end; ``train``
splits each global batch over the ranks and ``test`` each sampler batch
(where ``eval.batch_size`` splits evenly); the other modes refuse to run
under it.
"""

from __future__ import annotations

import argparse
import importlib.util
import os

import torch

from . import configs

MODES = ["train", "test", "multi_scale_test", "compute_dataset_statistics", "evaluation_pipeline"]


def load_config(name: str):
    """A recipe by name, by the path of a JAX recipe file the port copies,
    or from a file that defines ``get_config()``."""
    from .configs import inverse_problems, score_sde

    for table in (inverse_problems, score_sde):
        key = table.recipe_key(name)
        if key is not None:
            return table.RECIPES[key]()
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

    distributed = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if distributed and args.mode not in ("train", "test"):
        raise SystemExit(f"--mode {args.mode} runs in one process; only train and test run under torchrun")
    config = load_config(args.config)
    if args.data_path is not None:
        # a leaf recipe, or each recipe of a master config
        for recipe in [config] if "data" in config else vars(config).values():
            if hasattr(recipe, "data") and "base_dir" in recipe.data:
                recipe.data.base_dir = args.data_path
    if args.mode in ("train", "test"):
        from . import parallel

        device = parallel.init_distributed(args.device) if distributed else args.device
        try:
            if args.mode == "train":
                from .training.trainer import train

                train(config, args.log_path, args.checkpoint_path, device=device)
            else:
                from .eval.harness import run_test

                run_test(config, args.log_path, args.checkpoint_path, device=device)
        finally:
            if distributed:
                torch.distributed.destroy_process_group()
    elif args.mode == "multi_scale_test":
        from .eval.multiscale import run_multi_scale_test

        run_multi_scale_test(config, args.log_path, device=args.device)
    elif args.mode == "compute_dataset_statistics":
        from .data.statistics import compute_dataset_statistics

        compute_dataset_statistics(config, device=args.device)
    else:
        evaluation_pipeline(config, device=args.device)


def _evaluate_one_config(config, device):
    """The pipeline at each of the recipe's snrs over its trees (JAX
    `run_lib.py:_evaluate_one_config`)."""
    from .eval.harness import output_dir
    from .eval.pipeline import run_evaluation_pipeline

    task = config.data.task
    mask_kwargs = {}
    if task == "inpainting" and config.eval.get("use_seed", False):
        mask_kwargs = dict(mask_coverage=config.data.get("mask_coverage", 0.25))
    return {
        snr: run_evaluation_pipeline(
            task, output_dir(config), snr, scale=config.data.get("scale", 8), device=device, **mask_kwargs
        )
        for snr in config.eval.snr
    }


def evaluation_pipeline(master_config, device="cuda"):
    """The pipeline over a leaf recipe, or over each sub-recipe of a master
    config (JAX `run_lib.py:evaluation_pipeline`)."""
    if "training" in master_config:
        return _evaluate_one_config(master_config, device)
    return {name: _evaluate_one_config(sub, device) for name, sub in vars(master_config).items()}


if __name__ == "__main__":
    main()
