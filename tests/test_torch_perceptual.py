"""The port's perceptual metrics (`eval/inception.py`, `eval/lpips.py`,
`eval/fid.py`) and their wiring into the harness and the pipeline, against
the JAX package's, on synthetic weights.

The real weights are not in the repo.  The reference-named torch replicas
of pytorch-fid's InceptionV3 and of lpips-alex (`_torch_port_perceptual`,
copied from `tests/test_inception_lpips_oracle.py`) get seeded synthetic
weights, BatchNorm running statistics included; their state dicts, saved
as the reference files are, load into both packages.

* Inception taps 0-3 (with the 299 resize and the 2x - 1 input map), float64
  on the port's side, against the JAX Flax model: 1e-4 of each tap's
  largest magnitude; the same through the converter of JAX's folded tree.
  The replica's state dict, and one with the reference file's ``fc``
  head, load strictly.
* The 299 resize (`ops.resize.resize_bilinear`) against `jax.image.resize
  (..., "bilinear")`, up and down: 1e-6 of the image's largest magnitude.
* LPIPS against JAX's `load_lpips` on the same files: 1e-4 relative; the
  converter of JAX's tree; zero for identical images.
* FID and joint FID against JAX `eval/fid.py` on the same activations:
  1e-8 relative with more images than features; with fewer, the port's
  exact low-rank trace against JAX's `sqrtm`, 1e-6.
* The loaders' `FileNotFoundError` messages are JAX's.
* The pipeline on a written PNG tree with the weights' env vars set:
  ``per_draw`` LPIPS at 1e-4, ``fid`` / ``joint_fid`` (on the first 32
  Inception features in both packages: JAX's 4,096-feature `sqrtm` takes
  minutes) at 1e-4,
  ``best_25_lpips_ids`` and ``skipped`` equal to JAX's; without them,
  JAX's ``skipped`` notes.  The harness (`run_test`, the toy of
  `tests/test_torch_harness.py`, the JAX key chain replayed) reports
  JAX's per-batch ``lpips`` at 1e-4.
"""

import contextlib
import io
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import _torch_port_perceptual as oracle
from _torch_port_toy import Replay, jax_sampler_draws, jax_toy_params, reset_jax_dispatch
from conditional_score_diffusion_tpu.eval import fid as jax_fid
from conditional_score_diffusion_tpu.eval import harness as jax_harness
from conditional_score_diffusion_tpu.eval import pipeline as jax_pipeline
from conditional_score_diffusion_tpu.eval.inception import InceptionV3FID as JaxInception
from conditional_score_diffusion_tpu.eval.inception import load_fid_inception_params
from conditional_score_diffusion_tpu.eval.lpips import load_lpips as jax_load_lpips
from conditional_score_diffusion_tpu_torch.eval import fid, inception, lpips
from conditional_score_diffusion_tpu_torch.eval.pipeline import run_evaluation_pipeline
from conditional_score_diffusion_tpu_torch.ops.resize import resize_bilinear

torch.set_num_threads(1)

TAP_TOL, LPIPS_TOL, RESIZE_TOL, FID_TOL, LOW_RANK_TOL, PIPELINE_TOL = 1e-4, 1e-4, 1e-6, 1e-8, 1e-6, 1e-4
PIPELINE_FEATURES = 32  # the pipeline test's FID on the first 32 of the 2,048 features: scipy's sqrtm of
# JAX's 4,096-feature joint FID takes minutes
ENV = ("CSDT_INCEPTION_WEIGHTS", "CSDT_LPIPS_ALEXNET", "CSDT_LPIPS_LIN")


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Synthetic reference-named weight files: ``{env var: path}``."""
    d = tmp_path_factory.mktemp("weights")
    paths = {k: str(d / name) for k, name in zip(ENV, ("pt_inception.pth", "alexnet.pth", "alex_lin.pth"))}
    torch.save(oracle._randomize(oracle.TFIDInception(), seed=1).state_dict(), paths[ENV[0]])
    torch.save(oracle._alexnet_state_dict(seed=2), paths[ENV[1]])
    torch.save(oracle._lin_state_dict(seed=3), paths[ENV[2]])
    return paths


def _hold(got, want, tol, label):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, label
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), (label, np.abs(got - want).max())


def test_inception_taps_match_jax(weights):
    path = weights[ENV[0]]
    x = np.random.RandomState(0).rand(2, 40, 40, 3).astype(np.float32)
    params = load_fid_inception_params(path)
    try:
        want = jax.jit(lambda p, v: JaxInception(output_blocks=(0, 1, 2, 3)).apply({"params": p}, v))(params, x)
    finally:
        reset_jax_dispatch()
    net = inception.load_fid_inception(path, output_blocks=(0, 1, 2, 3), device="cpu", dtype=torch.float64)
    folded = inception.InceptionV3FID((0, 1, 2, 3)).double()
    folded.load_state_dict(inception.inception_state_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        for model, label in ((net, "reference file"), (folded, "JAX tree")):
            got = model(torch.from_numpy(x).double())
            for i, (g, w) in enumerate(zip(got, want)):
                _hold(g.numpy(), w, TAP_TOL, f"{label} tap {i}")
    assert got[3].shape == (2, 2048)


def test_inception_loads_the_reference_names(weights, tmp_path):
    sd = torch.load(weights[ENV[0]])
    inception.InceptionV3FID().load_state_dict(sd, strict=True)
    sd.update({"fc.weight": torch.zeros(1008, 2048), "fc.bias": torch.zeros(1008)})
    torch.save(sd, tmp_path / "with_fc.pth")
    inception.load_fid_inception(str(tmp_path / "with_fc.pth"), device="cpu")


@pytest.mark.parametrize("size", [(24, 40), (299, 299), (512, 350)])
def test_resize_matches_jax(size):
    """The port's resize is JAX's map (its float32 weights, exactly where
    it enlarges) computed in float64 within 1e-6.  JAX's own float32
    result lies up to 2.3e-6 from that map here (its CPU dot rounds
    coarser than float32 sums of a few terms), so the port's distance to
    JAX's output is held to JAX's distance from the map plus 1e-6."""
    from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

    x = np.random.RandomState(1).rand(2, *size, 3).astype(np.float32)
    got = resize_bilinear(torch.from_numpy(x), (299, 299)).numpy()
    w = [np.asarray(compute_weight_mat(n, 299, 299 / n, 0.0, _fill_triangle_kernel, True), np.float64) for n in size]
    exact = np.einsum("bowc,wp->bopc", np.einsum("bhwc,ho->bowc", x.astype(np.float64), w[0]), w[1])
    _hold(got, exact, RESIZE_TOL, size)
    want = np.asarray(jax.image.resize(x, (2, 299, 299, 3), "bilinear"))
    assert np.abs(got - want).max() <= np.abs(want - exact).max() + RESIZE_TOL * np.abs(exact).max(), size


def test_lpips_matches_jax(weights):
    rng = np.random.RandomState(2)
    a, b = rng.rand(3, 48, 48, 3).astype(np.float32), rng.rand(3, 48, 48, 3).astype(np.float32)
    jfn = jax_load_lpips(weights[ENV[1]], weights[ENV[2]])
    want = np.asarray(jfn(a, b))
    model = lpips.load_lpips(weights[ENV[1]], weights[ENV[2]], device="cpu", dtype=torch.float64)
    _hold(lpips.distances(model, a, b), want, LPIPS_TOL, "lpips")
    assert np.abs(lpips.distances(model, a, a)).max() <= 1e-12
    # the converter of JAX's tree
    params = {"alex": {}, "lin": {}}
    alex, lin = torch.load(weights[ENV[1]]), torch.load(weights[ENV[2]])
    for i, idx in enumerate(lpips.ALEX_INDICES):
        params["alex"][f"conv{i}"] = {"kernel": alex[f"features.{idx}.weight"].numpy().transpose(2, 3, 1, 0),
                                      "bias": alex[f"features.{idx}.bias"].numpy()}
        params["lin"][f"lin{i}"] = lin[f"lin{i}.model.1.weight"].numpy().reshape(-1)
    converted = lpips.LPIPS().double()
    converted.load_state_dict(lpips.lpips_state_from_flax(params), strict=True)
    _hold(lpips.distances(converted, a, b), want, LPIPS_TOL, "lpips from the JAX tree")


@pytest.mark.parametrize("n,d,tol", [(40, 16, FID_TOL), (8, 64, LOW_RANK_TOL), (16, 128, LOW_RANK_TOL)])
def test_fid_matches_jax(n, d, tol):
    """More images than features: JAX's computation, 1e-8.  No more than
    features: the port's trace from the singular values of ``X1 X2^T``
    (exact) against JAX's `sqrtm` of the singular product, which rounds
    its zero eigenvalues into ~1e-7 of the distance: 1e-6."""
    rng = np.random.RandomState(3)
    acts = [rng.randn(n, d) * s + m for s, m in ((1.0, 0.0), (1.3, 0.2), (0.8, -0.1))]
    for got, want in (
        (fid.fid_from_activations(acts[0], acts[1]), jax_fid.fid_from_activations(acts[0], acts[1])),
        (fid.joint_fid_from_activations(*acts), jax_fid.joint_fid_from_activations(*acts)),
        (fid.frechet_distance(np.zeros(2), np.zeros((2, 2)), np.ones(2), np.eye(2)),
         jax_fid.frechet_distance(np.zeros(2), np.zeros((2, 2)), np.ones(2), np.eye(2))),
    ):
        assert abs(got - want) <= tol * abs(want)


def test_loaders_raise_jax_messages(weights, monkeypatch):
    from conditional_score_diffusion_tpu.eval.inception import load_fid_inception_params as jax_load_inception

    def same_error(port_fn, jax_fn):
        with pytest.raises(FileNotFoundError) as want:
            jax_fn()
        with pytest.raises(FileNotFoundError) as got:
            port_fn(device="cpu")
        assert str(got.value) == str(want.value)

    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    same_error(inception.load_fid_inception, jax_load_inception)
    same_error(lpips.load_lpips, jax_load_lpips)
    monkeypatch.setenv(ENV[1], weights[ENV[1]])  # the heads still missing
    same_error(lpips.load_lpips, jax_load_lpips)


def _write_tree(base, n=6, size=32):
    rng = np.random.RandomState(4)
    gt = rng.randint(0, 256, (n, size, size, 3), dtype=np.uint8)
    dirs = {"x_gt": gt, "y_gt": gt[:, ::4, ::4]}
    for d in (1, 2):
        dirs[f"samples/snr_0.150/draw_{d}"] = np.clip(gt.astype(int) + rng.randint(-40, 41, gt.shape), 0, 255)
    for name, images in dirs.items():
        os.makedirs(os.path.join(base, "images", name))
        for i, img in enumerate(images):
            Image.fromarray(img.astype(np.uint8)).save(os.path.join(base, "images", name, f"{i + 1}.png"))


def test_pipeline_matches_jax(weights, tmp_path, monkeypatch):
    base = str(tmp_path)
    _write_tree(base)
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    bare = run_evaluation_pipeline("super-resolution", base, 0.15, scale=4, device="cpu")
    jbare = jax_pipeline.run_evaluation_pipeline("super-resolution", base, 0.15, scale=4)
    assert bare["skipped"] == jbare["skipped"] and len(bare["skipped"]) == 2
    assert "fid" not in bare and "best_25_lpips_ids" not in bare

    for k, v in weights.items():
        monkeypatch.setenv(k, v)
    from conditional_score_diffusion_tpu.eval import inception as jax_inception

    real_create, real_activations = jax_inception.create_inception, inception.activations

    def create_sliced(blocks, params):
        apply_fn, params = real_create(blocks, params)
        return (lambda p, x: [apply_fn(p, x)[0][:, :PIPELINE_FEATURES]]), params

    monkeypatch.setattr(jax_inception, "create_inception", create_sliced)
    monkeypatch.setattr(inception, "activations", lambda *a, **k: real_activations(*a, **k)[:, :PIPELINE_FEATURES])
    try:
        want = jax_pipeline.run_evaluation_pipeline("super-resolution", base, 0.15, scale=4)
    finally:
        reset_jax_dispatch()
    got = run_evaluation_pipeline("super-resolution", base, 0.15, scale=4, device="cpu")
    assert got["skipped"] == want["skipped"] == []
    assert sorted(got) == sorted(want)
    assert got["best_25_lpips_ids"] == want["best_25_lpips_ids"] and len(got["best_25_lpips_ids"]) == 6
    for draw, entry in want["per_draw"].items():
        assert sorted(got["per_draw"][draw]) == sorted(entry)
        assert abs(got["per_draw"][draw]["lpips"] - entry["lpips"]) <= PIPELINE_TOL * entry["lpips"]
    for k in ("fid", "joint_fid"):
        assert abs(got[k]["mean"] - want[k]["mean"]) <= PIPELINE_TOL * want[k]["mean"], k
        assert abs(got[k]["std"] - want[k]["std"]) <= PIPELINE_TOL * want[k]["mean"], k


def test_harness_reports_jax_lpips(weights, tmp_path, monkeypatch):
    from test_torch_harness import STEPS, _toy
    from conditional_score_diffusion_tpu.configs.celeba_sr import celeba_sr_interpolation_config as jax_recipe
    from conditional_score_diffusion_tpu_torch.configs import celeba_sr_interpolation_config
    from conditional_score_diffusion_tpu_torch.eval.harness import run_test
    from conditional_score_diffusion_tpu_torch.models.convert import flax_to_state_dict
    from conditional_score_diffusion_tpu_torch.training.checkpoint import save_ema

    for k, v in weights.items():
        monkeypatch.setenv(k, v)
    jconfig, config = _toy(jax_recipe("ours_NDV"), tmp_path / "jax"), _toy(celeba_sr_interpolation_config("ours_NDV"),
                                                                          tmp_path / "port")
    for c in (jconfig, config):
        c.eval.last_test_batch, c.eval.draws = 1, [1, 2]
    module, params = jax_toy_params(jconfig, seed=3)
    monkeypatch.setattr(jax_harness, "init_model", lambda config, rng: (module, params))
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            want = jax_harness.run_test(jconfig, str(tmp_path))
    finally:
        reset_jax_dispatch()
    key, draws = jax.random.key(jconfig.seed + 17), []
    for _ in range(2):
        key, dr = jax.random.split(key)
        draws += [np.asarray(d) for d in jax_sampler_draws(dr, STEPS, (2, 32, 32, 3), use_path=False)]
    ema = save_ema(str(tmp_path / "ema.pt"), 0, flax_to_state_dict(params))
    with contextlib.redirect_stdout(io.StringIO()):
        got = run_test(config, "", checkpoint_path=ema, device="cpu", noise=Replay(draws))
    assert sorted(got[0.15]) == sorted(want[0.15]) and "lpips" in got[0.15]
    g, w = got[0.15]["lpips"], want[0.15]["lpips"]
    assert len(g) == len(w) == 1 and abs(g[0] - w[0]) <= PIPELINE_TOL * abs(w[0]), (g, w)
