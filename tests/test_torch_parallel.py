"""Data parallelism over `torch.distributed` (`parallel/`, the port of JAX
`parallel/mesh.py`) on the CPU.

One 2-rank gloo run (`tests/_torch_parallel_worker.py`, ``file://`` init
under ``tmp_path``) on the toy `ddpm_paired` CMDE (32px, nf=32, dropout 0)
against world 1 (the same functions in this process, no process group) and
JAX:

* 2 train steps on the JAX key chain's injected t and noise, each rank
  holding its rows, against JAX's ``make_train_step`` at the tolerances of
  `tests/test_torch_train.py`;
* 2 steps on the generator's draws: loss and grad_norm within 1e-6 of
  world 1, the all-reduced gradients tensor by tensor (`assert_close_run`:
  1e-5 of each tensor's largest at the first step, not 1e-6, since each
  rank's backward and the all-reduce sum in another order), params and EMA
  as `tests/test_torch_train.py` holds them; the ranks' params, EMA and
  Adam moments bit for bit;
* ``accumulate_grad_batches=2`` (global batch 4) against world 1;
* the eval loss (the mean over the ranks) against world 1, and a batch of 3
  that does not split, evaluated whole on each rank;
* `Trainer.fit(2)` with an eval and a snapshot: world 1's losses, rank 0
  alone writing (checkpoint, scalars);
* the sharded conditional PC sampler (3 steps) within 1e-6 of world 1;
* a batch that does not split evenly raises.

In this process: the losses' ``draws`` make the draws the losses make
themselves, each branch; every sample of the toy U-Nets (GroupNorm), an
NCSNv2 (InstanceNorm++) and an NCSN++ is the same alone as in its batch (no
layer has statistics across samples); `local_batch` and `sharded_noise`.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import _torch_parallel_worker as worker
from _torch_port_toy import hold_gradients, jax_step_draws, jax_toy_params, toy_inputs, train_toy_configs
from conditional_score_diffusion_tpu_torch import parallel
from conditional_score_diffusion_tpu_torch.losses.continuous import get_general_sde_loss_fn
from conditional_score_diffusion_tpu_torch.losses.discrete import (
    get_ddpm_loss_fn,
    get_inverse_problem_smld_loss_fn,
    get_smld_loss_fn,
)
from conditional_score_diffusion_tpu_torch.models import init_model_random
from conditional_score_diffusion_tpu_torch.models.convert import flax_to_state_dict
from conditional_score_diffusion_tpu_torch.sde import VESDE, VPSDE
from test_torch_train import GRAD_TOL, KEY, LOSS_RTOL, _hold_params, _jax_run
from test_torch_trainer import toy_recipe

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
REL = 1e-6
GRAD_REL, GRAD_TOP = 1e-5, 5e-6


def rel(got, want):
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def spawn(directory, inputs):
    torch.save(inputs, os.path.join(directory, "inputs.pt"))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO, GLOO_SOCKET_IFNAME="lo")
    script = os.path.join(REPO, "tests", "_torch_parallel_worker.py")
    procs = [subprocess.Popen([sys.executable, script, directory, str(r), str(WORLD)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [torch.load(os.path.join(directory, f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]


def assert_ranks_equal(a, b):
    for key in ("params", "ema"):
        for n in a[key]:
            assert torch.equal(a[key][n], b[key][n]), (key, n)
    for n, (m, v) in a["adam"].items():
        assert torch.equal(m, b["adam"][n][0]) and torch.equal(v, b["adam"][n][1]), n
    assert a["metrics"] == b["metrics"]


def assert_close_run(got, want, start):
    """Loss and grad_norm of each step at REL.  The gradients after the
    all-reduce (as clipped): at the first step, from the same parameters on
    both sides, each tensor within GRAD_REL of its largest magnitude
    (`hold_gradients`; rounding-noise tensors at 1e-6 of the largest of
    all); at every step, every element within GRAD_TOP of the largest
    gradient of all.  Float32 sums in another order (each rank's backward
    over its rows, then the all-reduce of the halves) move a gradient whose
    terms cancel by up to 7.3e-6 of its tensor's largest at the first step
    and any element by up to 2.4e-6 of the largest of all by the second
    (measured here), so neither holds at the 1e-6 of the loss.  Params and EMA as
    `test_torch_train._hold_params` holds the port against JAX: every
    element at 1e-6 of its tensor's largest magnitude outside the elements
    of small gradients (below 1e-2 of the tensor's largest at some step)
    and the tensors of rounding-noise gradients, and each tensor's update
    by norm at 2e-3.  Adam divides each gradient by its own magnitude, so
    the summation order's rounding in a small or cancelling gradient moves
    its element's update by up to ~lr: updates differ by up to 8.9e-4 by
    norm between world 1 and 2 here."""
    for g, w in zip(got["metrics"], want["metrics"]):
        assert abs(g["loss"] - w["loss"]) <= REL * abs(w["loss"]), (g, w)
        assert abs(g["grad_norm"] - w["grad_norm"]) <= REL * w["grad_norm"], (g, w)
    hold_gradients(got["grads"][0], want["grads"][0], GRAD_REL)
    for g, w in zip(got["grads"], want["grads"]):
        top = max(t.abs().max().item() for t in w.values())
        worst = max((g[n] - t).abs().max().item() for n, t in w.items())
        assert worst <= GRAD_TOP * top, (worst, top)
    excluded = _hold_params(got["params"], want["params"], want["grads"], start)
    excluded += _hold_params(got["ema"], want["ema"], want["grads"], start)
    assert excluded <= 0.25 * 2 * sum(p.numel() for p in want["params"].values())


def test_world_two_reproduces_world_one_and_jax(tmp_path):
    jconfig, tconfig = train_toy_configs()
    module, params = jax_toy_params(jconfig)
    state_dict = flax_to_state_dict(params)
    x, y, _ = toy_inputs()
    batch = {"x": x, "y": y}
    x4, y4, _ = toy_inputs(batch=4, seed=3)
    x3, y3, _ = toy_inputs(batch=3, seed=4)
    config_accum = train_toy_configs(batch=4)[1]
    config_accum.training.accumulate_grad_batches = 2
    trainer_config = toy_recipe()
    trainer_config.training.eval_freq = trainer_config.training.snapshot_freq = 2
    shapes = {k: v.shape for k, v in batch.items()}
    inputs = dict(
        config=tconfig, config_accum=config_accum, trainer_config=trainer_config, state_dict=state_dict,
        batch=batch, batch4={"x": x4, "y": y4}, batch3={"x": x3, "y": y3},
        jax_draws=[{k: np.asarray(v) for k, v in jax_step_draws(KEY, i, shapes).items()} for i in range(2)],
    )
    ranks = spawn(str(tmp_path), inputs)
    assert [(r["rank"], r["world"]) for r in ranks] == [(0, 2), (1, 2)]
    r0, r1 = ranks

    # the JAX key chain's draws: against JAX's train step
    states, grads, jmetrics = _jax_run(jconfig, module, params, {k: jax.numpy.asarray(v) for k, v in batch.items()}, 2)
    for got, want in zip(r0["jax_noise"]["metrics"], jmetrics):
        assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
        assert abs(got["grad_norm"] - want["grad_norm"]) <= GRAD_TOL * want["grad_norm"]
    start = flax_to_state_dict(params)
    n = 2 * sum(p.numel() for p in r0["jax_noise"]["params"].values())
    excluded = _hold_params(r0["jax_noise"]["params"], flax_to_state_dict(states[-1].params), grads, start)
    excluded += _hold_params(r0["jax_noise"]["ema"], flax_to_state_dict(states[-1].ema.params), grads, start)
    assert excluded <= 0.25 * n
    assert_ranks_equal(r0["jax_noise"], r1["jax_noise"])
    assert_close_run(r0["jax_noise"], worker.train_run(tconfig, state_dict, batch, 2, inputs["jax_draws"]), start)

    # the generator's draws, accumulation: world 1 in this process
    for key, args in (("generator", (tconfig, state_dict, batch, 2)),
                      ("accumulate", (config_accum, state_dict, inputs["batch4"], 2))):
        assert_ranks_equal(r0[key], r1[key])
        assert_close_run(r0[key], worker.train_run(*args), start)
    assert r0["generator"]["metrics"][0]["grad_norm"] > 0

    assert r0["eval"] == r1["eval"]
    assert abs(r0["eval"] - worker.eval_run(tconfig, state_dict, batch, 11)) <= REL * abs(r0["eval"])
    assert r0["eval_uneven"] == r1["eval_uneven"] == worker.eval_run(tconfig, state_dict, inputs["batch3"], 12)

    # the Trainer: world 1's losses; rank 0 alone writes
    want = worker.trainer_run(trainer_config, str(tmp_path / "world1"), 2)
    for r in ranks:
        got = r["trainer"]["history"]
        for key in ("train_loss", "eval_loss"):
            assert [s for s, _ in got[key]] == [s for s, _ in want["history"][key]], key
            for (_, g), (_, w) in zip(got[key], want["history"][key]):
                assert abs(g - w) <= REL * abs(w), (key, g, w)
    assert len(want["history"]["eval_loss"]) == 1
    assert r0["trainer"]["files"] == want["files"]
    assert "checkpoints/checkpoint_2.pt" in r0["trainer"]["files"] and "scalars.jsonl" in r0["trainer"]["files"]
    assert r1["trainer"]["files"] == [] and r1["trainer"]["scalars"] == []

    # the sharded sampler: every rank holds the global batch
    assert r0["sample"].shape == (2, 32, 32, 3) and torch.equal(r0["sample"], r1["sample"])
    assert rel(r0["sample"], worker.sample_run(tconfig, state_dict, y, 5, 3)) <= REL

    for r in ranks:
        assert "does not split evenly" in r["uneven_train"]
        assert "does not split evenly" in r["uneven_sample"]


class _Score(torch.nn.Module):
    """A stand-in network: a learned scale of its input."""

    def __init__(self, x_only=False):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(0.7))
        self.x_only = x_only  # SR3: the score of x alone

    def forward(self, inputs, labels):
        scale = self.w * (1.0 + 1e-3 * labels.float()).reshape(-1, *([1] * 3))
        if self.x_only:
            return inputs["x"] * scale
        if isinstance(inputs, dict):
            return {k: v * scale for k, v in inputs.items()}
        return inputs * scale


def _loss_cases():
    ve = VESDE(0.01, 50.0, N=10)
    multi = {"x": VESDE(0.01, 50.0, N=10), "y": VESDE(0.01, 1.0, N=10)}
    pair = {"x": torch.rand(3, 4, 4, 2), "y": torch.rand(3, 4, 4, 2), "mask": torch.ones(3, 4, 4, 1)}
    single = torch.rand(3, 4, 4, 2)
    m = _Score()
    return [
        ("multispeed", get_general_sde_loss_fn(m, conditional=True), multi, pair),
        ("sr3", get_general_sde_loss_fn(_Score(x_only=True), conditional=True), ve, pair),
        ("unconditional", get_general_sde_loss_fn(m, conditional=False), ve, single),
        ("smld", get_smld_loss_fn(m), ve, single),
        ("inverse_smld", get_inverse_problem_smld_loss_fn(m), multi, pair),
        ("ddpm", get_ddpm_loss_fn(m), VPSDE(0.1, 20.0, 10), single),
    ]


@pytest.mark.parametrize("case", range(6))
def test_loss_draws_are_the_losses_own(case):
    """``loss_fn.draws`` makes, in order, what ``loss_fn`` draws itself:
    the same loss from a generator and from the injected draws, and the
    generator left in the same state."""
    name, loss_fn, sde, batch = _loss_cases()[case]
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    want = loss_fn(sde, batch, generator=g1)
    shapes = batch.shape if torch.is_tensor(batch) else {k: v.shape for k, v in batch.items()}
    draws = loss_fn.draws(sde, shapes, g2, torch.device("cpu"))
    times = {k: draws.pop(k) for k in ("t", "labels") if k in draws}
    got = loss_fn(sde, batch, noise=draws, **times)
    assert torch.equal(got, want), name
    assert torch.equal(g1.get_state(), g2.get_state()), name


@pytest.mark.parametrize("family", ["ddpm_paired", "ncsnpp", "ncsnv2"])
def test_no_layer_couples_samples(family):
    """Each sample's output alone equals its row of the batch's output, in
    train mode (the loss's mode; dropout 0), at float32 rounding."""
    from conditional_score_diffusion_tpu_torch.configs import base as torch_base
    from _torch_port_toy import ncsnpp_toy_config, torch_toy_config

    torch.manual_seed(0)
    if family == "ddpm_paired":
        config = torch_toy_config(fused_tail=False)
        config.model.dropout = 0.0
        inputs = {"x": torch.rand(3, 32, 32, 3), "y": torch.rand(3, 32, 32, 3)}
    elif family == "ncsnpp":
        config = ncsnpp_toy_config(torch_base)
        inputs = torch.rand(3, 16, 16, 3)
    else:
        from conditional_score_diffusion_tpu_torch.configs.ncsn_legacy import ncsnv2_config

        config = ncsnv2_config("cifar10")
        config.model.nf = 16
        config.data.image_size = config.data.effective_image_size = 32
        inputs = torch.rand(3, 32, 32, 3)
    model = init_model_random(config, seed=2, device="cpu").train()
    labels = torch.tensor([3.0, 400.0, 900.0]) if family != "ncsnv2" else torch.tensor([0.5, 10.0, 40.0])
    with torch.no_grad():
        whole = model(inputs, labels)
        for i in range(3):
            row = {k: v[i:i + 1] for k, v in inputs.items()} if isinstance(inputs, dict) else inputs[i:i + 1]
            alone = model(row, labels[i:i + 1])
            for k in (whole if isinstance(whole, dict) else {"x": None}):
                w = whole[k][i:i + 1] if isinstance(whole, dict) else whole[i:i + 1]
                a = alone[k] if isinstance(alone, dict) else alone
                assert rel(a, w) <= 1e-5, (family, i, k, rel(a, w))


def test_local_batch_and_sharded_noise():
    batch = {"x": torch.arange(12).reshape(6, 2), "y": np.arange(6)}
    assert torch.equal(parallel.local_batch(batch, 1, 3)["x"], torch.tensor([[4, 5], [6, 7]]))
    assert list(parallel.local_batch(batch, 2, 3)["y"]) == [4, 5]
    with pytest.raises(ValueError, match="does not split evenly"):
        parallel.local_batch(batch, 0, 4)
    gen = torch.Generator().manual_seed(1)
    full = torch.randn((6, 3), generator=gen)
    for r in range(3):
        gen = torch.Generator().manual_seed(1)
        draw = parallel.sharded_noise(lambda s: torch.randn(s, generator=gen), r, 3)
        assert torch.equal(draw((2, 3)), full[2 * r:2 * r + 2])
    assert parallel.world_size() == 1 and parallel.rank() == 0 and not parallel.is_distributed()


def test_world_one_group_is_the_plain_run(tmp_path):
    """Under a one-rank gloo group (in this process) the trainer, the eval
    loss and the sharded sampler give the plain run's numbers bit for bit:
    what `chip_smoke.py` phases 26-27 hold on the card with NCCL."""
    config = toy_recipe()
    config.training.eval_freq = config.training.snapshot_freq = 2
    _, tconfig = train_toy_configs()
    jconfig_params = jax_toy_params(train_toy_configs()[0])[1]
    state_dict = flax_to_state_dict(jconfig_params)
    x, y, _ = toy_inputs()
    plain = worker.trainer_run(config, str(tmp_path / "plain"), 2)
    plain_sample = worker.sample_run(tconfig, state_dict, y, 5, 2)
    parallel.init_distributed("cpu", init_method=f"file://{tmp_path}/pg", rank=0, world_size=1)
    try:
        assert parallel.is_distributed() and parallel.world_size() == 1
        grouped = worker.trainer_run(config, str(tmp_path / "grouped"), 2)
        grouped_sample = worker.sample_run(tconfig, state_dict, y, 5, 2)
    finally:
        torch.distributed.destroy_process_group()
    assert grouped["history"] == plain["history"]
    assert grouped["files"] == plain["files"]
    assert torch.equal(grouped_sample, plain_sample)
    assert not parallel.is_distributed()


TORCHRUN_RECIPE = '''
from conditional_score_diffusion_tpu_torch.configs import celeba_sr_160_config


def get_config():
    c = celeba_sr_160_config("ours_NDV")
    c.data.image_size = c.data.effective_image_size = c.data.target_resolution = 32
    c.data.shape_x = c.data.shape_y = [3, 32, 32]
    c.model.nf, c.model.ch_mult, c.model.num_res_blocks, c.model.attn_resolutions = 32, (1, 2, 2), 1, (16,)
    c.data.dataset, c.data.datamodule, c.data.base_dir = "texture64", "General_PKLDataset", {datasets!r}
    c.training.batch_size, c.training.n_iters, c.training.log_freq = 4, 2, 1
    c.training.eval_freq = c.training.snapshot_freq = 2
    c.training.visualization_p_steps = 2
    c.eval.batch_size, c.eval.max_val_batches = 2, 1
    c.eval.first_test_batch, c.eval.last_test_batch, c.eval.draws, c.eval.p_steps = 0, 1, [1], 2
    c.eval.base_log_dir = {base!r}
    c.optim.warmup = 0
    return c
'''


def test_torchrun_cli_trains_and_tests_on_two_ranks(tmp_path):
    """``torchrun --nproc_per_node=2 -m ...main --mode train`` and ``--mode
    test`` on the CPU (gloo): rank 0 alone writes the checkpoint, the
    scalars, the PNG tree and the metrics file; the ranks leave the group."""
    from conditional_score_diffusion_tpu_torch.eval.harness import output_dir
    from conditional_score_diffusion_tpu_torch.main import load_config
    from conditional_score_diffusion_tpu_torch.training.trainer import read_scalars

    recipe = tmp_path / "recipe.py"
    recipe.write_text(TORCHRUN_RECIPE.format(datasets=os.path.join(REPO, "datasets"), base=str(tmp_path / "eval")))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO, GLOO_SOCKET_IFNAME="lo")
    logs = tmp_path / "logs"

    def torchrun(*args):
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2", "-m",
             "conditional_score_diffusion_tpu_torch.main", "--config", str(recipe), "--device", "cpu", *args],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
        )
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        return proc.stdout

    torchrun("--mode", "train", "--log_path", str(logs))
    assert sorted(os.listdir(logs / "checkpoints")) == ["checkpoint_2.pt"]
    scalars = read_scalars(str(logs / "scalars.jsonl"))
    assert [s for t, _, s in scalars if t == "train_loss"] == [1, 2]
    assert [s for t, _, s in scalars if t == "eval_loss"] == [2]

    out = torchrun("--mode", "test", "--checkpoint_path", str(logs / "checkpoints"))
    assert out.count("[test] batch 0 done") == 1
    base = output_dir(load_config(str(recipe)))
    for d in ("x_gt", "y_gt", os.path.join("samples", "snr_0.150", "draw_1")):
        assert sorted(os.listdir(os.path.join(base, "images", d))) == ["1.png", "2.png"], d
    assert os.listdir(os.path.join(base, "test_metrics")) == ["0_1.pkl"]
