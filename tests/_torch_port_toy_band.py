"""The band that `chip_smoke.py` holds the port's GaussianBubbles toy in.

    JAX_PLATFORMS=cpu python tests/_torch_port_toy_band.py [--seeds 0 1 2]

Trains the JAX package's FCN on the 2-D GaussianBubbles toy as
`scripts/head_to_head.py:run_jax` does (10,000 steps, B=256, the recipe of
`configs/toy_gaussian_bubbles.py`: lr 1e-3, warmup 100, clip 1, EMA 0.999,
VE sigma 0.01-2, likelihood-weighted DSM), then draws 4,000 PC samples
(reverse_diffusion + langevin, snr 0.15, 500 steps) from the EMA weights and
scores them with `head_to_head.sample_metrics` against its ground-truth
draws (``make_data(999, 4000)``).  Seed ``s`` moves every random stream of
that script by ``s`` (init ``key(s)``, batches ``default_rng(1 + s)``, the
step keys from ``key(42 + s)``, the sample ``key(7 + s)``), so seed 0 is
the committed `artifacts/head_to_head/results.json` run.  Prints one JSON
line per seed, ground truth against itself, and the band: the range over
the seeds widened by half its width on each side, and never narrower than
ground truth against itself (the metrics' own sampling noise at 4,000
points).  About 20 s a seed on a CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import jax  # noqa: E402
import numpy as np  # noqa: E402

import head_to_head as h2h  # noqa: E402

METRICS = ("mode_mass_maxdev", "energy_distance_vs_gt")


def run_seed(seed: int, steps: int) -> dict:
    import jax.numpy as jnp
    import ml_collections

    from conditional_score_diffusion_tpu.models import init_model
    from conditional_score_diffusion_tpu.models.wrappers import get_score_fn
    from conditional_score_diffusion_tpu.sampling import get_pc_sampler
    from conditional_score_diffusion_tpu.sde import build_sde
    from conditional_score_diffusion_tpu.training.state import create_train_state
    from conditional_score_diffusion_tpu.training.steps import make_train_step

    HP = h2h.HP
    c = ml_collections.ConfigDict()
    c.training = ml_collections.ConfigDict(dict(
        sde="vesde", continuous=True, reduce_mean=True, likelihood_weighting=True, batch_size=HP["batch_size"],
    ))
    c.model = ml_collections.ConfigDict(dict(
        name="fcn", state_size=2, hidden_layers=HP["hidden_layers"], hidden_nodes=HP["hidden_nodes"],
        dropout=HP["dropout"], sigma_min=HP["sigma_min"], sigma_max=HP["sigma_max"],
        num_scales=HP["num_scales"], ema_rate=HP["ema_rate"], beta_min=0.1, beta_max=20.0,
    ))
    c.optim = ml_collections.ConfigDict(dict(
        lr=HP["lr"], warmup=HP["warmup"], grad_clip=HP["grad_clip"], beta1=0.9, eps=1e-8, weight_decay=0.0,
        optimizer="Adam",
    ))
    c.data = ml_collections.ConfigDict(dict(shape=[2]))

    data = h2h.make_data(0, HP["data_samples"])
    module, params = init_model(c, jax.random.key(seed))
    state = create_train_state(c, params)
    train_step = jax.jit(make_train_step(c, module)[0])
    rng = np.random.default_rng(1 + seed)
    key = jax.random.key(42 + seed)
    for _ in range(steps):
        batch = jnp.asarray(data[rng.integers(0, len(data), HP["batch_size"])])
        key, sub = jax.random.split(key)
        state, _ = train_step(state, batch, sub)
    sde, eps = build_sde(c)
    score_fn = get_score_fn(sde, module, state.ema.params, conditional=False, train=False, continuous=True)
    sampler = get_pc_sampler(
        sde, (HP["n_samples"], 2), "reverse_diffusion", "langevin",
        snr=HP["snr"], p_steps=HP["sample_steps"], c_steps=1, denoise=True, eps=HP["eps"],
    )
    samples = np.asarray(jax.jit(lambda r: sampler(r, score_fn)[0])(jax.random.key(7 + seed)))
    return h2h.sample_metrics(samples, h2h.make_data(999, HP["n_samples"]))


def band(values, floor):
    """The range of ``values`` widened by half its width on each side, its
    top at least ``floor``; the bottom at least 0 (both metrics are
    non-negative: the lower, the closer to the data)."""
    lo, hi = min(values), max(values)
    w = hi - lo
    return max(0.0, lo - w / 2), max(hi + w / 2, floor)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--steps", type=int, default=10000)
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    runs = {}
    for s in args.seeds:
        runs[s] = run_seed(s, args.steps)
        print(json.dumps({"seed": s, **{k: runs[s][k] for k in METRICS}}), flush=True)
    gt = h2h.sample_metrics(h2h.make_data(555, h2h.HP["n_samples"]), h2h.make_data(999, h2h.HP["n_samples"]))
    print(json.dumps({"ground_truth": {k: gt[k] for k in METRICS}}))
    print(json.dumps({"band": {k: band([r[k] for r in runs.values()], gt[k]) for k in METRICS}}))


if __name__ == "__main__":
    main()
