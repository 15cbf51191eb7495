"""The port's likelihood (`sampling/likelihood.py`), bits/dim over a split
(`eval/bpd.py`) and the kernel gates under a gradient, against the JAX
package.

* `get_likelihood_fn` with the same data and fixed probe (Rademacher or
  Gaussian) under VE, VP and sub-VP: on the exact score of Gaussian data
  (one expression in both frameworks) bpd at 1e-4 absolute and z at 1e-4
  of its scale, with the same number of score evaluations; on a 16px
  NCSN++ with FIR and a 16px DDPM (each framework's own network) within
  the float32 reproducibility of the solver there (see the test).
* The analytic bpd of N(0, 1) data within 0.1, as JAX
  `tests/test_sampling.py:209-223`.
* The reverse-mode divergence eps^T J eps against `torch.func.jvp` of the
  drift (the plain path: the CPU), 1e-5.
* `evaluate_bpd` against JAX's on a 4-image pklv4 file written here, with
  JAX's probes replayed, 1e-4; `run_test` calls it under JAX's condition
  (``eval.enable_bpd`` and no ``training.conditioning_approach``).
* A call that carries a gradient takes the plain versions of kernels 1-3
  (`models/layers.py:carries_grad`): the divergence of a toy Haar DDPM
  with ``fused_block`` and ``fused_tail`` on, in eval mode, calls no kernel
  entry and equals the one with the knobs off; the same score under
  `no_grad` calls them.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_toy import Replay, ncsnpp_toy_config, reset_jax_dispatch, unconditional_toy_pair
from conditional_score_diffusion_tpu.configs import base as jax_base
from conditional_score_diffusion_tpu.data import pkl_datasets as jax_pkl
from conditional_score_diffusion_tpu.eval.bpd import evaluate_bpd as jax_evaluate_bpd
from conditional_score_diffusion_tpu.models.wrappers import get_score_fn as jax_get_score_fn
from conditional_score_diffusion_tpu.sampling.likelihood import get_likelihood_fn as jax_get_likelihood_fn
from conditional_score_diffusion_tpu.sde import build_sde as jax_build_sde
from conditional_score_diffusion_tpu_torch.configs import base as torch_base
from conditional_score_diffusion_tpu_torch.configs import haar_multiscale_unconditional_config
from conditional_score_diffusion_tpu_torch.configs import texture64_sr_cmde_test_config
from conditional_score_diffusion_tpu_torch.data.pkl_datasets import PKLDataModule
from conditional_score_diffusion_tpu_torch.eval import bpd as bpd_module
from conditional_score_diffusion_tpu_torch.eval import harness
from conditional_score_diffusion_tpu_torch.models import create_model, init_model_random, layers
from conditional_score_diffusion_tpu_torch.models.wrappers import get_score_fn
from conditional_score_diffusion_tpu_torch.sampling import get_likelihood_fn
from conditional_score_diffusion_tpu_torch.sampling.likelihood import get_div_fn
from conditional_score_diffusion_tpu_torch.sde import VESDE, batch_mul, build_sde

torch.set_num_threads(1)

SHAPE = (2, 16, 16, 3)


def toy_pair(name, sde_name="vesde", seed=7, out_scale=0.002):
    """The 16px toy with its output conv scaled by ``out_scale``: a random
    network's score over a small sigma makes the flow chaotic (at scale 1 a
    1e-6 change of the data moved z by 60% under VP)."""
    return unconditional_toy_pair(name, sde_name, seed, out_scale)


def probe(kind, seed, shape=SHAPE):
    z = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return np.where(z < 0, -1.0, 1.0).astype(np.float32) if kind == "rademacher" else z


def counted(fn):
    """``fn`` with a host counter of its calls at run time."""
    calls = [0]

    def wrapped(*args):
        jax.debug.callback(lambda: calls.__setitem__(0, calls[0] + 1))
        return fn(*args)

    return wrapped, calls


def hold_likelihood(got, want_bpd, want_z, bpd_tol, z_tol):
    bpd, z, nfe = got
    want_z = np.asarray(want_z)
    assert nfe == -1 and bpd.shape == want_bpd.shape and z.shape == want_z.shape
    np.testing.assert_allclose(bpd.numpy(), np.asarray(want_bpd), rtol=0, atol=bpd_tol)
    np.testing.assert_allclose(z.numpy(), want_z, rtol=0, atol=z_tol * np.abs(want_z).max())


MU, S = 0.5, 0.7


def gaussian_score(sde, bmul, ones_like):
    """The exact score of data N(MU, S^2) under ``sde`` in either framework."""

    def score(x, t):
        mean, std = sde.marginal_prob(ones_like(t), t)
        return -bmul(1.0 / (S**2 * mean**2 + std**2), x - bmul(mean, MU * ones_like(x)))

    return score


ANALYTIC = [(sde, kind) for sde in ("vesde", "vpsde", "subvpsde") for kind in ("rademacher", "gaussian")]


@pytest.mark.parametrize("case", ANALYTIC, ids=["-".join(c) for c in ANALYTIC])
def test_likelihood_matches_jax(case):
    """The exact Gaussian score, one expression in both frameworks: the same
    steps (score evaluations counted on both sides), bpd at 1e-4 absolute,
    z at 1e-4 of its scale."""
    from conditional_score_diffusion_tpu import sde as jax_sde
    from conditional_score_diffusion_tpu_torch import sde as torch_sde

    sde_name, kind = case
    cls = {"vesde": "VESDE", "vpsde": "VPSDE", "subvpsde": "subVPSDE"}[sde_name]
    args = (0.01, 10.0, 200) if sde_name == "vesde" else ()
    jsde, tsde = getattr(jax_sde, cls)(*args), getattr(torch_sde, cls)(*args)
    data = (MU + S * np.random.RandomState(0).randn(*SHAPE)).astype(np.float32)
    epsilon = probe(kind, seed=3)
    jscore, calls = counted(gaussian_score(jsde, jax_sde.batch_mul, jnp.ones_like))
    want_bpd, want_z, _ = jax_get_likelihood_fn(jsde, hutchinson_type=kind)(
        jax.random.key(0), jscore, jnp.asarray(data), epsilon=jnp.asarray(epsilon)
    )
    tscore, nfe = gaussian_score(tsde, batch_mul, torch.ones_like), [0]

    def score(x, t):
        nfe[0] += 1
        return tscore(x, t)

    got = get_likelihood_fn(tsde, hutchinson_type=kind)(None, score, torch.from_numpy(data), epsilon=torch.from_numpy(epsilon))
    hold_likelihood(got, want_bpd, want_z, 1e-4, 1e-4)
    assert nfe[0] == calls[0] // 2  # JAX evaluates the score twice a call: the drift and the jvp


TOYS = [("ncsnpp", "vesde", "rademacher"), ("ncsnpp", "vpsde", "gaussian"), ("ncsnpp", "subvpsde", "rademacher"),
        ("ddpm", "vesde", "gaussian"), ("ddpm", "vpsde", "rademacher"), ("ddpm", "subvpsde", "gaussian")]


@pytest.mark.parametrize("case", TOYS, ids=["-".join(c) for c in TOYS])
def test_likelihood_on_the_toys_matches_jax(case):
    """Each framework's own network, the same weights, data and probe: bpd
    within 3e-3 (2e-4 of its ~16 bits), z within 2e-2 of its scale.  That is
    the float32 reproducibility of the solver on these networks, not a
    property of the port: the error ratio counts the two log-densities
    among 1,538 elements, so their error is not controlled, and a change of
    1e-7 of the divergence (below float32 resolution) took other steps and
    moved the port's own bpd by 1.4e-3 and z by 3.1e-2 of its scale.  The
    analytic cases above hold the likelihood's arithmetic at 1e-4."""
    name, sde_name, kind = case
    jconfig, tconfig, module, params, model = toy_pair(name, sde_name)
    data = np.random.RandomState(1).rand(*SHAPE).astype(np.float32)
    epsilon = probe(kind, seed=2)
    try:
        jsde, _ = jax_build_sde(jconfig)
        want_bpd, want_z, _ = jax_get_likelihood_fn(jsde, hutchinson_type=kind)(
            jax.random.key(0), jax_get_score_fn(jsde, module, params, continuous=True), jnp.asarray(data),
            epsilon=jnp.asarray(epsilon),
        )
    finally:
        reset_jax_dispatch()
    sde, _ = build_sde(tconfig)
    got = get_likelihood_fn(sde, hutchinson_type=kind)(
        None, get_score_fn(sde, model, continuous=True), torch.from_numpy(data), epsilon=torch.from_numpy(epsilon)
    )
    hold_likelihood(got, want_bpd, want_z, 3e-3, 2e-2)


def test_gaussian_bpd_is_analytic():
    sde = VESDE(sigma_min=0.01, sigma_max=10.0, N=200)

    def score(x, t):
        return -batch_mul(1.0 / (1.0 + sde.marginal_prob(x, t)[1] ** 2), x)

    data = torch.from_numpy(np.random.RandomState(0).randn(512, 2).astype(np.float32))
    bpd, z, _ = get_likelihood_fn(sde, eps=1e-5)(torch.Generator().manual_seed(1), score, data)
    analytic = 0.5 * np.log2(2 * np.pi * np.e) + 8.0
    assert abs(bpd.mean().item() - analytic) < 0.1 and torch.isfinite(z).all()


@pytest.mark.parametrize("kind", ["rademacher", "gaussian"])
def test_reverse_mode_divergence_is_the_jvp(kind):
    _, tconfig, _, _, model = toy_pair("ncsnpp", seed=4)
    sde, _ = build_sde(tconfig)
    rsde = sde.reverse(get_score_fn(sde, model, continuous=True), probability_flow=True)

    def drift_fn(x, t):
        return rsde.sde(x, t.expand(x.shape[0]))[0]

    x = torch.from_numpy(np.random.RandomState(5).rand(*SHAPE).astype(np.float32))
    eps = torch.from_numpy(probe(kind, seed=6))
    t = torch.tensor(0.37)
    got = get_div_fn(drift_fn, kind)(x, t, eps)
    _, jvp = torch.func.jvp(lambda xx: drift_fn(xx, t), (x,), (eps,))
    want = torch.sum(jvp * eps, dim=(1, 2, 3))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


def _tiny_split(tmp_path, n=4, size=16):
    """``{tmp}/tiny/tiny-{train,val,test}.pklv4``: ``n`` uint8 images from a seed."""
    images = list(np.random.RandomState(8).randint(0, 256, size=(n, size, size, 3)).astype(np.uint8))
    os.makedirs(tmp_path / "tiny")
    for split in ("train", "val", "test"):
        with open(tmp_path / "tiny" / f"tiny-{split}.pklv4", "wb") as f:
            pickle.dump(images, f)


class _TorchScale(torch.nn.Module):
    """A network that scales its input by a learnt per-channel vector."""

    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w))

    def forward(self, x, labels):
        return x * self.w


def test_evaluate_bpd_matches_jax(tmp_path):
    """Two batches of two through the unpaired datamodule, JAX's probes
    replayed, on a network both frameworks compute with one elementwise
    expression (x times a per-channel vector), so the solver takes the
    same steps: the mean bpd at 1e-4."""
    import flax.linen as nn

    w = np.array([-0.01, -0.02, 0.005], np.float32)

    class JaxScale(nn.Module):
        @nn.compact
        def __call__(self, x, labels, train=False):
            return x * self.param("w", lambda key: jnp.asarray(w))

    _tiny_split(tmp_path)
    jconfig, tconfig = ncsnpp_toy_config(jax_base), ncsnpp_toy_config(torch_base)
    for c in (jconfig, tconfig):
        c.data.dataset, c.data.base_dir, c.data.datamodule = "tiny", str(tmp_path), "unpaired_PKLDataset"
        c.eval.batch_size = 2
    jdm = jax_pkl.UnpairedPKLDataModule(jconfig)
    jdm.setup()
    want = jax_evaluate_bpd(jconfig, JaxScale(), {"w": jnp.asarray(w)}, jdm, max_batches=2)
    # JAX's probes: a key per batch from seed + 3, split again inside the likelihood
    rng, probes = jax.random.key(jconfig.seed + 3), []
    for _ in range(2):
        rng, r = jax.random.split(rng)
        eps_rng = jax.random.split(r)[1]
        probes.append(jax.random.randint(eps_rng, SHAPE, 0, 2).astype(jnp.float32) * 2 - 1)
    noise = Replay(probes)
    got = bpd_module.evaluate_bpd(tconfig, _TorchScale(w), PKLDataModule(tconfig), max_batches=2, device="cpu",
                                  noise=noise)
    assert not noise.draws
    assert abs(got - want) <= 1e-4


@pytest.mark.parametrize("conditional", [False, True], ids=["unconditional", "conditional"])
def test_run_test_evaluates_bpd_under_jaxs_condition(tmp_path, monkeypatch, conditional):
    """A spy for `evaluate_bpd`: called once, with the harness's model and
    the recipe's datamodule, only where the recipe names no
    ``conditioning_approach``; the harness's dict carries its value."""
    config = texture64_sr_cmde_test_config()
    config.data.base_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "datasets")
    config.eval.base_log_dir = str(tmp_path)
    config.eval.enable_bpd = True
    config.eval.first_test_batch = config.eval.last_test_batch = 0  # no sampling: the bpd call alone
    if not conditional:
        delattr(config.training, "conditioning_approach")
    calls = []

    def spy(cfg, model, datamodule, **kw):
        calls.append((cfg, model, type(datamodule).__name__, kw))
        return 3.25

    monkeypatch.setattr(harness, "evaluate_bpd", spy)
    results = harness.run_test(config, checkpoint_path=str(tmp_path / "none"), device="cpu")
    if conditional:
        assert calls == [] and "bpd" not in results
    else:
        assert len(calls) == 1 and calls[0][0] is config and calls[0][2] == "PKLDataModule"
        assert isinstance(calls[0][1], torch.nn.Module) and results["bpd"] == 3.25


def _haar_toy(fused):
    c = haar_multiscale_unconditional_config(32)
    c.model.nf, c.model.ch_mult, c.model.num_res_blocks, c.model.attn_resolutions = 16, (1, 2), 1, (4,)
    c.model.fused_block = c.model.fused_tail = fused
    return c


def test_a_gradient_takes_the_plain_versions(monkeypatch):
    """Kernel 1 sits at 16x16, kernels 2-3 at 8x8 of the toy Haar DDPM
    (16x16x12 coefficients); with a gradient through x none is called."""
    seen = []
    for name in ("gn_silu_conv3x3", "resblock_fused", "resblock_fused_split"):
        real = getattr(layers, name)
        monkeypatch.setattr(layers, name, lambda *a, real=real, name=name, **k: seen.append(name) or real(*a, **k))
    on, off = _haar_toy(True), _haar_toy(False)
    model = init_model_random(on, seed=3, device="cpu").eval()
    model_off = create_model(off, "cpu").eval()
    model_off.load_state_dict(model.state_dict())
    sde, _ = build_sde(on)
    x = torch.from_numpy(np.random.RandomState(9).randn(2, 16, 16, 12).astype(np.float32))
    eps = torch.from_numpy(probe("rademacher", 10, x.shape))
    t = torch.tensor(0.5)
    divs = []
    for m in (model, model_off):
        rsde = sde.reverse(get_score_fn(sde, m, continuous=True), probability_flow=True)
        divs.append(get_div_fn(lambda xx, tt: rsde.sde(xx, tt.expand(2))[0])(x, t, eps))
    assert seen == [] and model.training is False
    torch.testing.assert_close(divs[0], divs[1], rtol=1e-5, atol=1e-5 * divs[1].abs().max().item())
    with torch.no_grad():
        get_score_fn(sde, model, continuous=True)(x, t.expand(2))
    assert sorted(set(seen)) == ["gn_silu_conv3x3", "resblock_fused", "resblock_fused_split"]
