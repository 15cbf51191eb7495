"""The port and chip_smoke.py import nothing of JAX nor of the JAX package.

A subprocess installs an import hook that refuses jax, flax, optax,
ml_collections, absl and conditional_score_diffusion_tpu, then imports every
module of the port, chip_smoke (as a module; its main does not run) and the
card-only test files, which run on a machine without JAX.
"""

import os
import subprocess
import sys
import textwrap

import jax  # noqa: F401  (the parity files import both frameworks)
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent(
    """
    import importlib, importlib.abc, pkgutil, sys

    REFUSED = {"jax", "jaxlib", "flax", "optax", "ml_collections", "absl",
               "conditional_score_diffusion_tpu"}

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in REFUSED:
                raise ImportError("refused import of " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    import conditional_score_diffusion_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    sys.path.insert(0, "tests")
    import test_torch_conv3x3_cuda, test_torch_fir_cuda, test_torch_fused_act_cuda, test_torch_fused_block_cuda
    import test_torch_fused_tail_cuda
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
    assert not loaded, loaded
    print(len(names), "modules")
    print(" ".join(names))
    """
)


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    n = int(proc.stdout.split()[0])
    assert n >= 20, proc.stdout
    names = proc.stdout.splitlines()[1].split()
    for name in (
        "ops.fused_block", "ops.fused_tail", "ops.nvcc", "configs.texture160_sr_cmde_bf16_block",
        "ops.upfirdn", "ops.fir", "models.layerspp", "models.ncsnpp", "training.schedules",
        "configs.srflow", "configs.texture160_kxsr_ncsnpp", "configs.texture160_kxsr_ncsnpp_block",
        "profile_sampler", "ops.conv3x3", "ops.forward_only", "losses.continuous", "losses.factory",
        "models.ema", "training.state", "training.steps", "training.tasks", "training.checkpoint",
        "training.trainer", "main", "configs.texture160_sr_cmde_conv3x3", "profile_train_step",
        "ops.fused_act", "eval.metrics", "eval.harness", "eval.pipeline", "configs.texture64_sr_cmde",
        "configs.texture64_sr_cmde_test", "sde.vp", "configs.extra", "configs.texture160_sr",
        "configs.texture64_sr_dv", "sampling.pc", "sampling.predictors", "sampling.correctors",
        "ops.haar", "eval.multiscale", "configs.multiscale", "training.callbacks", "models.ddpm",
        "data.pkl_datasets", "data.synthetic", "models.fcn", "configs.toy", "eval.toy",
        "sampling.odeint", "sampling.ode", "sampling.likelihood", "sampling.controllable", "eval.bpd",
        "data.degradations", "data.paired", "data.statistics", "configs.inverse_problems", "models.ddpm3d",
        "models.ncsnv2", "models.normalization", "losses.discrete", "data.image_folder", "configs.song",
        "configs.ncsn_legacy", "configs.score_sde", "data.builder", "data.sr_multiscale", "eval.fid",
        "eval.inception", "eval.lpips",
    ):
        assert f"conditional_score_diffusion_tpu_torch.{name}" in names, name
