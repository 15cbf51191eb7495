"""The port's Haar-space and bicubic multi-scale recipes against the JAX
package's, and the three places where the port runs what JAX cannot.

* The recipe functions `configs.extra.haar_conditional_config` /
  `haarflow_config` and `configs.srflow.celeba_haar_config` /
  `celeba_bicubic_config`, with every argument a recipe file passes, field
  by field (`test_torch_recipes.assert_same`), the knobs no code reads
  included.
* The 25 recipe files of `configs/ve/haarflow/`, `configs/vp/haarflow/`
  and `configs/ve/srflow/` by path, through the table
  (`configs.score_sde.RECIPES`) and `main.load_config`; the master files
  scale by scale, with no ``coordinate_space``, as JAX's.
* The repairs.  A ``haar_multiscale`` batch is one array; JAX's
  conditional tasks hand it to a loss that indexes ``batch["x"]`` and
  fail, where the port's split it into the Haar detail and approximation
  bands (JAX's `haar_forward` split, exactly).  JAX's ``ddpm`` takes no
  ``{x, y}`` and fails under a conditional task; the port's gives their
  joint score (JAX's ``ddpm`` on the concatenation, 5e-4).  JAX's
  ``ddpm_SR`` with the celebA recipes' 12 output channels leaves the y
  score no channel and its loss failing; the port's outputs 15.
* A one-step ``--mode train`` of a toy twin of
  `configs/ve/srflow/celebA/haar/config_40.py` through the CLI on a tree
  from `data/builder.py`.
* A 3-step ``--mode multi_scale_test`` of a toy two-scale chain of the
  celebA Haar family (`celeba_haar_config` scales at 8 and 16 on
  ``haar_multiscale`` trees) against JAX's, the JAX key chain's draws
  replayed and the JAX datamodule's arrays split as the port splits them:
  the final images at 1e-4 of their scale.
"""

import math
import os

import jax
import jax.numpy as jnp
import ml_collections
import numpy as np
import pytest
import torch

from _torch_port_toy import Replay, randomize_params, reset_jax_dispatch
from test_torch_haar_datasets import write_images
from test_torch_multiscale import chain_draws, port_config
from test_torch_recipes import assert_same
from test_torch_song_recipes import jax_recipe
from conditional_score_diffusion_tpu.configs import extra as jax_extra
from conditional_score_diffusion_tpu.configs import srflow as jax_srflow
from conditional_score_diffusion_tpu.data import create_datamodule as jax_create_datamodule
from conditional_score_diffusion_tpu.eval import multiscale as jax_ms
from conditional_score_diffusion_tpu.losses.factory import build_loss_fn as jax_build_loss_fn
from conditional_score_diffusion_tpu.models import get_model as jax_get_model
from conditional_score_diffusion_tpu.ops.haar import haar_forward as jax_haar_forward
from conditional_score_diffusion_tpu.sde import build_sde as jax_build_sde
from conditional_score_diffusion_tpu.training.tasks import create_task as jax_create_task
from conditional_score_diffusion_tpu_torch import main as cli
from conditional_score_diffusion_tpu_torch.configs import extra, score_sde, srflow
from conditional_score_diffusion_tpu_torch.data import builder, create_datamodule
from conditional_score_diffusion_tpu_torch.eval import multiscale
from conditional_score_diffusion_tpu_torch.losses.factory import build_loss_fn
from conditional_score_diffusion_tpu_torch.main import load_config
from conditional_score_diffusion_tpu_torch.models import create_model
from conditional_score_diffusion_tpu_torch.models.convert import flax_to_state_dict
from conditional_score_diffusion_tpu_torch.sde import build_sde
from conditional_score_diffusion_tpu_torch.training.checkpoint import save_ema
from conditional_score_diffusion_tpu_torch.training.tasks import create_task
from conditional_score_diffusion_tpu_torch.training.trainer import read_scalars

torch.set_num_threads(1)

FORWARD_TOL = 5e-4
CHAIN_TOL = 1e-4
TREES = ("ve/haarflow/", "vp/haarflow/", "ve/srflow/")
KEYS = sorted(k for k in score_sde.RECIPES if k.startswith(TREES))

RECIPE_CALLS = [
    ("haar_conditional_config", ()), ("haar_conditional_config", (128, 256)), ("haar_conditional_config", (64, 128)),
    ("haarflow_config", (128, "vesde")), ("haarflow_config", (64, "vpsde")), ("haarflow_config", ()),
    ("celeba_haar_config", (40,)), ("celeba_haar_config", (80,)), ("celeba_haar_config", (160,)),
    ("celeba_bicubic_config", (40,)), ("celeba_bicubic_config", (80,)), ("celeba_bicubic_config", (160,)),
]


@pytest.mark.parametrize("name,args", RECIPE_CALLS)
def test_recipe_functions_match_jax(name, args):
    port, jax_module = (srflow, jax_srflow) if name.startswith("celeba") else (extra, jax_extra)
    assert_same(getattr(jax_module, name)(*args), getattr(port, name)(*args))


def test_bicubic_reduce_both_matches_jax():
    assert_same(jax_srflow.celeba_bicubic_config(80, reduce_both=True), srflow.celeba_bicubic_config(80, reduce_both=True))


def assert_same_recipe_file(want, got):
    if "training" in want:
        assert_same(want, got)
        return
    assert "coordinate_space" not in want and "coordinate_space" not in got
    assert sorted(want.keys()) == sorted(vars(got))
    for key in want.keys():
        assert_same(want[key], getattr(got, key))


@pytest.mark.parametrize("key", KEYS)
def test_recipe_file_matches_jax(key):
    want = jax_recipe(key)
    assert_same_recipe_file(want, score_sde.RECIPES[key]())
    assert_same_recipe_file(want, load_config(os.path.join("configs", key + ".py")))
    assert_same_recipe_file(want, load_config(key))


def test_the_table_holds_the_25_files():
    assert len(KEYS) == 25
    masters = [k for k in KEYS if k.endswith("master_config")]
    assert len(masters) == 4
    assert [len(vars(score_sde.RECIPES[k]())) for k in masters] == [3, 2, 3, 3]


# ---- the repairs ------------------------------------------------------------


def shrink_haar(config, image_size, base_dir, target=16):
    """A `celeba_haar_config` scale at toy size: ``image_size`` of a
    ``target`` px pyramid, nf 8, ch_mult (1, 2), one resblock a level,
    10 noise scales, batch 2; the recipe's sigma formulas kept."""
    d, m = config.data, config.model
    d.base_dir, d.target_resolution, d.image_size = base_dir, target, image_size
    d.level = math.log(target // image_size, 2)
    d.effective_image_size = image_size // 2
    d.shape_x = [9, image_size // 2, image_size // 2]
    d.shape_y = [3, image_size // 2, image_size // 2]
    m.nf, m.ch_mult, m.num_res_blocks, m.attn_resolutions = 8, (1, 2), 1, (image_size // 4,)
    m.num_scales, m.dropout = 10, 0.0
    if m.name == "ddpm_paired":
        m.sigma_max_x = float(np.sqrt(np.prod(d.shape_x)) * 2 ** (d.level + 1))
        m.sigma_max_y = float(np.sqrt(np.prod(d.shape_y)))
        m.sigma_max_y_target = m.sigma_max_y / 2
    config.training.batch_size = config.eval.batch_size = 2
    return config


def haar_tree(tmp_path, n=16):
    src = write_images(str(tmp_path / "raw"), n=n)
    builder.create_haar_dataset(src, str(tmp_path), "celebA", 16, max_depth=1, split=(0.5, 0.25, 0.25), seed=0)
    return str(tmp_path)


def test_conditional_task_splits_haar_arrays(tmp_path):
    """The port's task turns the datamodule's array into JAX's Haar split;
    JAX's loss fails on the array its task hands on."""
    base = haar_tree(tmp_path)
    jconfig = shrink_haar(jax_srflow.celeba_haar_config(40), 8, base)
    config = port_config(jconfig)
    dm = create_datamodule(config)
    dm.setup()
    array = next(dm.train_iterator())
    assert array.shape == (2, 8, 8, 3)
    batch = create_task(config, None).prepare_batch(array)
    z = np.asarray(jax_haar_forward(jnp.asarray(array)))
    np.testing.assert_array_equal(batch["y"], z[..., :3])
    np.testing.assert_array_equal(batch["x"], z[..., 3:])
    assert batch["x"].shape == (2, 4, 4, 9)

    jtask = jax_create_task(jconfig, None)
    assert jtask.prepare_batch(array) is array
    jloss = jax_build_loss_fn(jconfig, None, jtask.sde, train=True)
    with pytest.raises((IndexError, TypeError)):
        jloss(None, jtask.sde, jnp.asarray(array), jax.random.key(0))
    sde = build_sde(config)[0]
    loss = build_loss_fn(config, create_model(config, "cpu"), sde, train=True)
    assert torch.isfinite(loss(sde, {k: torch.from_numpy(v) for k, v in batch.items()}, torch.Generator()))


def test_ddpm_takes_the_joint_haar_input(tmp_path):
    """celebA Haar scale 80's ``ddpm`` under its conditional task: the port's
    score of ``{x, y}`` is JAX's ``ddpm`` on ``cat(x, y)``, split."""
    jconfig = shrink_haar(jax_srflow.celeba_haar_config(80), 8, str(tmp_path))
    config = port_config(jconfig)
    rng = np.random.RandomState(0)
    x, y = rng.randn(2, 4, 4, 9).astype(np.float32), rng.rand(2, 4, 4, 3).astype(np.float32)
    t = np.array([3.0, 7.5], np.float32)
    try:
        module = jax_get_model("ddpm").from_config(jconfig)
        joint = jnp.concatenate([x, y], axis=-1)
        params = jax.eval_shape(lambda: module.init({"params": jax.random.key(0)}, joint, jnp.asarray(t)))["params"]
        params = randomize_params(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), params), seed=2)
        want = np.asarray(jax.jit(lambda p: module.apply({"params": p}, joint, jnp.asarray(t)))(params))
        with pytest.raises(AttributeError):
            jax.eval_shape(lambda: module.apply({"params": params}, {"x": x, "y": y}, jnp.asarray(t)))
    finally:
        reset_jax_dispatch()
    model = create_model(config, "cpu")
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = model({"x": torch.from_numpy(x), "y": torch.from_numpy(y)}, torch.from_numpy(t))
    top = np.abs(want).max()
    assert got["x"].shape == x.shape and got["y"].shape == y.shape
    assert np.abs(got["x"].numpy() - want[..., :9]).max() <= FORWARD_TOL * top
    assert np.abs(got["y"].numpy() - want[..., 9:]).max() <= FORWARD_TOL * top


def test_ddpm_sr_scores_y_too():
    """celebA bicubic's ``ddpm_SR`` (``output_channels`` 12): JAX's y score
    has no channel, the port's has y's 3, and its two-domain loss runs."""
    jconfig = jax_srflow.celeba_bicubic_config(40)
    d, m = jconfig.data, jconfig.model
    d.image_size, d.effective_image_size, d.shape_x, d.shape_y = 16, 8, [3, 16, 16], [3, 8, 8]
    m.nf, m.ch_mult, m.num_res_blocks, m.attn_resolutions = 8, (1, 2), 1, (4,)
    config = port_config(jconfig)
    inputs = {"x": jnp.zeros((1, 16, 16, 3)), "y": jnp.zeros((1, 8, 8, 3))}
    try:
        module = jax_get_model("ddpm_SR").from_config(jconfig)
        out = jax.eval_shape(lambda: module.init_with_output({"params": jax.random.key(0)}, inputs, jnp.ones(1)))[0]
    finally:
        reset_jax_dispatch()
    assert out["y"].shape == (1, 8, 8, 0)
    model = create_model(config, "cpu")
    assert model.unet.conv_out.weight.shape[0] == 15
    sde = build_sde(config)[0]
    batch = {"x": torch.rand(2, 16, 16, 3), "y": torch.rand(2, 8, 8, 3)}
    assert torch.isfinite(build_loss_fn(config, model, sde, train=True)(sde, batch, torch.Generator()))
    assert jax_build_sde(jconfig)[0]["y"].N == sde["y"].N


# ---- the CLI and the chain -----------------------------------------------------


def test_cli_trains_the_celeba_haar_config_40_twin(tmp_path, monkeypatch):
    """``--mode train --config configs/ve/srflow/celebA/haar/config_40.py
    --data_path <tree>``, the table entry cut to toy size for one step."""
    base = haar_tree(tmp_path)
    key = "ve/srflow/celebA/haar/config_40"
    real = score_sde.RECIPES[key]

    def toy():
        config = shrink_haar(real(), 8, "unused")
        config.training.n_iters, config.training.log_freq = 1, 1
        return config

    monkeypatch.setitem(score_sde.RECIPES, key, toy)
    log_path = str(tmp_path / "log")
    cli.main(["--mode", "train", "--config", f"configs/{key}.py", "--data_path", base, "--log_path", log_path,
              "--device", "cpu"])
    losses = [(step, v) for tag, v, step in read_scalars(os.path.join(log_path, "scalars.jsonl")) if tag == "train_loss"]
    assert [s for s, _ in losses] == [1] and np.isfinite(losses[0][1])
    assert os.listdir(os.path.join(log_path, "checkpoints"))


def test_celeba_haar_chain_matches_jax(tmp_path, monkeypatch):
    base = haar_tree(tmp_path)
    p_steps = 3
    jmaster = ml_collections.ConfigDict()
    for size in (8, 16):
        jmaster[f"config_{size}"] = shrink_haar(jax_srflow.celeba_haar_config(40), size, base)

    class SplitArrays:
        """JAX's datamodule with each test array split as the port's task splits it."""

        def __init__(self, config):
            self.dm = jax_create_datamodule(config)

        def setup(self):
            self.dm.setup()

        def test_iterator(self):
            for array in self.dm.test_iterator():
                z = np.asarray(jax_haar_forward(jnp.asarray(array)))
                yield {"x": z[..., 3:], "y": z[..., :3]}

    params = {}
    real_init = jax_ms.init_model

    def init_random(config, rng):
        module, p = real_init(config, rng)
        params[int(config.data.image_size)] = randomize_params(jax.device_get(p), seed=int(config.data.image_size))
        return module, params[int(config.data.image_size)]

    monkeypatch.setattr(jax_ms, "init_model", init_random)
    monkeypatch.setattr(jax_ms, "create_datamodule", SplitArrays)
    try:
        want = jax_ms.run_multi_scale_test(jmaster, str(tmp_path / "jax"), p_steps=p_steps, num_batches=1)
    finally:
        reset_jax_dispatch()

    master = port_config(jmaster)
    shapes = []
    for size in (8, 16):
        config = getattr(master, f"config_{size}")
        config.model.checkpoint_path = save_ema(str(tmp_path / f"ema_{size}.pt"), 0, flax_to_state_dict(params[size]))
        h = size // 2
        shapes.append(((2, h, h, 9), (2, h, h, 3)))
    noise = Replay(chain_draws(42, shapes, p_steps))
    got = multiscale.run_multi_scale_test(master, str(tmp_path / "port"), p_steps=p_steps, device="cpu", noise=noise)
    assert not noise.draws
    g, w = got[0], np.asarray(want[0])
    assert g.shape == w.shape == (2, 16, 16, 3) and np.isfinite(g).all()
    assert np.abs(g - w).max() <= CHAIN_TOL * np.abs(w).max(), (np.abs(g - w).max(), np.abs(w).max())


def test_legacy_haar_scales_keep_their_sigma_y():
    """celebA Haar 80 / 160 name no ``reach_target_steps``: JAX's schedule
    fails on the missing field, the port's keeps sigma_y at the recipe's."""
    from conditional_score_diffusion_tpu.training.schedules import sigma_y_at_step as jax_sigma_y_at_step
    from conditional_score_diffusion_tpu_torch.training.schedules import sigma_y_at_step

    for size in (80, 160):
        jconfig, config = jax_srflow.celeba_haar_config(size), srflow.celeba_haar_config(size)
        with pytest.raises((AttributeError, KeyError)):
            jax_sigma_y_at_step(jconfig, 100)
        assert sigma_y_at_step(config, 100) == (0.01, 450.0)
        task = create_task(config, None)
        task.reconfigure(5000)
        assert (task.sde["y"].sigma_min, task.sde["y"].sigma_max) == (0.01, 450.0)
    # a recipe with a schedule anneals as before
    config = srflow.celeba_haar_config(40)
    assert sigma_y_at_step(config, 8000)[1] == pytest.approx(config.model.sigma_max_y_target, rel=1e-6)


def test_bicubic_master_defaults_to_the_haar_space_in_both():
    """The bicubic master file names no ``coordinate_space``: both packages
    chain it in the haar space, which concatenates each scale's sample with
    its DC band, here 40px samples with a 20px band (the chip run sets
    ``bicubic``, the space these scales chain in)."""
    jmaster = jax_recipe("ve/srflow/celebA/bicubic/reduce_max_only/master_config")
    master = load_config("configs/ve/srflow/celebA/bicubic/reduce_max_only/master_config.py")
    assert jmaster.get("coordinate_space", "haar") == master.get("coordinate_space", "haar") == "haar"
    first = multiscale.scale_configs(master)[0]
    assert first.data.shape_x[1:] == [40, 40] and first.data.shape_y[1:] == [20, 20]


def test_chip_smoke_multiscale_constants():
    """`chip_smoke.py`'s calls per forward of the seven recipes' _block
    variants and the sites no earlier phase checked, counted again."""
    import chip_smoke

    assert sorted(chip_smoke.multiscale_sites()) == sorted(chip_smoke.MULTISCALE_NEW_SITES)
    assert [label for label, _ in chip_smoke.MULTISCALE_RECIPES] == list(chip_smoke.MULTISCALE_PER_FORWARD)
    assert [recipe for _, recipe, _ in chip_smoke.MULTISCALE_MASTERS] == [
        f"configs/{k}.py" for k in KEYS if k.startswith("ve/srflow/celebA/") and k.endswith("master_config")][::-1]
