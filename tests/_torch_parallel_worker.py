"""One rank of the data-parallel CPU test (`tests/test_torch_parallel.py`).

    python tests/_torch_parallel_worker.py <dir> <rank> <world>

Reads ``<dir>/inputs.pt`` (written by the test: recipes, weights, batches
and the JAX key chain's draws), joins a gloo group through
``file://<dir>/pg``, runs every case and writes ``<dir>/rank<rank>.pt``.
Imports no JAX: the test process computes the JAX side and the world-1
runs with the functions here.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from conditional_score_diffusion_tpu_torch import parallel  # noqa: E402
from conditional_score_diffusion_tpu_torch.models import create_model  # noqa: E402
from conditional_score_diffusion_tpu_torch.sampling import get_conditional_sampling_fn  # noqa: E402
from conditional_score_diffusion_tpu_torch.sde import build_sde  # noqa: E402
from conditional_score_diffusion_tpu_torch.training.state import create_train_state  # noqa: E402
from conditional_score_diffusion_tpu_torch.training.steps import make_eval_step, make_train_step  # noqa: E402
from conditional_score_diffusion_tpu_torch.training.trainer import Trainer, read_scalars  # noqa: E402


def tensors(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def model_of(config, state_dict):
    model = create_model(config, device="cpu")
    model.load_state_dict(state_dict, strict=True)
    return model


def train_run(config, state_dict, batch, steps, draws=None):
    """``steps`` train steps from ``state_dict`` on the global ``batch``,
    with the JAX draws of each step injected where ``draws`` is given."""
    model = model_of(config, state_dict)
    state = create_train_state(config, model)
    step = make_train_step(config, model)
    metrics, grads = [], []
    for i in range(steps):
        m = step(state, tensors(batch), noise=None if draws is None else tensors(draws[i]))
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    return {
        "metrics": metrics,
        "grads": grads,  # as clipped
        "params": {n: p.detach().clone() for n, p in model.named_parameters()},
        "ema": {n: p.clone() for n, p in state.ema.params.items()},
        "adam": {n: (state.optimizer.state[p]["exp_avg"].clone(), state.optimizer.state[p]["exp_avg_sq"].clone())
                 for n, p in model.named_parameters()},
    }


def eval_run(config, state_dict, batch, seed):
    model = model_of(config, state_dict)
    state = create_train_state(config, model)
    gen = torch.Generator().manual_seed(seed)
    return float(make_eval_step(config, model)(state, tensors(batch), gen)["eval_loss"])


def sample_run(config, state_dict, y, seed, p_steps):
    """The conditional PC sampler on ``y`` (global rows); sharded over the
    ranks where there is a process group."""
    model = model_of(config, state_dict)
    sde, eps = build_sde(config)
    world = parallel.world_size()
    shape = (y.shape[0] // world,) + tuple(y.shape[1:])
    fn = get_conditional_sampling_fn(config, sde, shape, eps, p_steps=p_steps)
    if parallel.is_distributed():
        fn = parallel.shard_sampling_fn(fn)
    with torch.no_grad():
        return fn(torch.Generator().manual_seed(seed), model, torch.from_numpy(y))[0]


def trainer_run(config, log_path, steps):
    trainer = Trainer(config, log_path, device="cpu")
    history = trainer.fit(max_steps=steps, callbacks=[])
    return {
        "history": history,
        "files": sorted(os.path.relpath(os.path.join(d, f), log_path) for d, _, fs in os.walk(log_path) for f in fs),
        "scalars": read_scalars(os.path.join(log_path, "scalars.jsonl"))
        if os.path.exists(os.path.join(log_path, "scalars.jsonl")) else [],
    }


def raises(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def run_all(inputs, directory, rank):
    c = inputs
    out = {
        "jax_noise": train_run(c["config"], c["state_dict"], c["batch"], 2, c["jax_draws"]),
        "generator": train_run(c["config"], c["state_dict"], c["batch"], 2),
        "accumulate": train_run(c["config_accum"], c["state_dict"], c["batch4"], 2),
        "eval": eval_run(c["config"], c["state_dict"], c["batch"], 11),
        "eval_uneven": eval_run(c["config"], c["state_dict"], c["batch3"], 12),
        "sample": sample_run(c["config"], c["state_dict"], c["batch"]["y"], 5, 3),
        "trainer": trainer_run(c["trainer_config"], os.path.join(directory, f"logs{rank}"), 2),
    }
    out["uneven_train"] = raises(lambda: train_run(c["config"], c["state_dict"], c["batch3"], 1))
    out["uneven_sample"] = raises(lambda: sample_run(c["config"], c["state_dict"], c["batch3"]["y"][:1], 5, 1))
    return out


def main(directory: str, rank: int, world: int) -> None:
    inputs = torch.load(os.path.join(directory, "inputs.pt"), weights_only=False)  # written by the test
    parallel.init_distributed("cpu", init_method=f"file://{directory}/pg", rank=rank, world_size=world)
    try:
        out = run_all(inputs, directory, rank)
        out["rank"], out["world"] = parallel.rank(), parallel.world_size()
    finally:
        torch.distributed.destroy_process_group()
    torch.save(out, os.path.join(directory, f"rank{rank}.pt"))


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
