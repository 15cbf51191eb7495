"""The port's VP and sub-VP SDEs, and every predictor and corrector step,
against the JAX package's at 1e-5.

The SDEs: `sde`, `marginal_prob`, `discretize` (its first step t = 0
too), `prior_logp`, the reverse SDE's `sde` and `discretize` with a score,
and the DDPM ladders, from the JAX and port factories (eps 1e-3).  The
steps: each predictor and corrector's ``x`` and ``x_mean`` with the JAX
draws injected (a predictor draws once from its key, a corrector from
``fold_in(key, i)`` on each of its steps), under VE, VP and sub-VP (the
ancestral step has no sub-VP branch: both raise), conditional (score
of (x, y, t)) and unconditional (score of (x, t)), with an analytic score.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_toy import Replay
from conditional_score_diffusion_tpu.configs.extra import cifar10_vp_config as jax_vp_config
from conditional_score_diffusion_tpu.sampling import correctors as jax_correctors
from conditional_score_diffusion_tpu.sampling import predictors as jax_predictors
from conditional_score_diffusion_tpu.sde import VESDE as JaxVESDE
from conditional_score_diffusion_tpu.sde import build_sde as jax_build_sde
from conditional_score_diffusion_tpu_torch.configs import cifar10_vp_config
from conditional_score_diffusion_tpu_torch.sampling import get_corrector, get_predictor
from conditional_score_diffusion_tpu_torch.sde import VESDE, VPSDE, build_sde, subVPSDE

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
SDES = ["vesde", "vpsde", "subvpsde"]


def sde_pair(name):
    if name == "vesde":
        return JaxVESDE(sigma_min=0.01, sigma_max=50.0, N=100), VESDE(sigma_min=0.01, sigma_max=50.0, N=100)
    jsde, jeps = jax_build_sde(jax_vp_config(name))
    tsde, teps = build_sde(cifar10_vp_config(name))
    assert jeps == teps == 1e-3 and isinstance(tsde, VPSDE if name == "vpsde" else subVPSDE)
    return jsde, tsde


def data(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(4, 8, 8, 3).astype(np.float32)
    t = np.array([1.0, 0.5, 1e-3, 0.0], np.float32)
    return x, t


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("name", ["vpsde", "subvpsde"])
def test_vp_sde_math_matches_jax(name):
    j, p = sde_pair(name)
    assert (p.beta_0, p.beta_1, p.N, p.T) == (float(j.beta_0), float(j.beta_1), j.N, j.T)
    x, t = data()
    jx, jt, tx, tt = jnp.asarray(x), jnp.asarray(t), torch.from_numpy(x), torch.from_numpy(t)
    for jf, tf in [(j.marginal_prob, p.marginal_prob), (j.sde, p.sde), (j.discretize, p.discretize)]:
        for a, b in zip(jf(jx, jt), tf(tx, tt)):
            close(b, a)
    close(p.marginal_prob(None, tt)[1], j.marginal_prob(jx, jt)[1])
    close(p.prior_logp(tx), j.prior_logp(jx))
    z = np.asarray(jax.random.normal(jax.random.key(2), x.shape))
    close(p.prior_sampling(lambda shape: torch.from_numpy(z), x.shape), j.prior_sampling(jax.random.key(2), x.shape))

    def jscore(a, s):
        return -a * (1.0 + s)[:, None, None, None]

    def tscore(a, s):
        return -a * (1.0 + s)[:, None, None, None]

    for pf in (False, True):
        jr, tr = j.reverse(jscore, pf), p.reverse(tscore, pf)
        for jf, tf in [(jr.sde, tr.sde), (jr.discretize, tr.discretize)]:
            for a, b in zip(jf(jx, jt), tf(tx, tt)):
                close(b, a)


def test_vp_ladders_match_jax():
    j, p = sde_pair("vpsde")
    for attr in ("discrete_betas", "alphas", "alphas_cumprod", "sqrt_1m_alphas_cumprod"):
        close(getattr(p, attr)("cpu"), getattr(j, attr))


def analytic_scores(conditional):
    """A score both frameworks compute, of (x, t) or (x, y, t)."""

    def make(np_):
        def uncond(x, t):
            return -(x - 0.5) * (1.0 + t)[:, None, None, None]

        def cond(x, y, t):
            return -(x - y) * (1.0 + t)[:, None, None, None]

        return cond if conditional else uncond

    return make(jnp), make(torch)


def step_inputs(name):
    rng = np.random.RandomState(3)
    scale = 20.0 if name == "vesde" else 1.0
    x = (scale * rng.randn(2, 8, 8, 3)).astype(np.float32)
    y = rng.rand(2, 8, 8, 3).astype(np.float32)
    # t inside the grid and at its first step, where the ladders' index 0 branch runs
    t = np.array([0.73, 0.0], np.float32)
    return x, y, t


PREDICTORS = ["euler_maruyama", "reverse_diffusion", "ancestral_sampling", "none"]


@pytest.mark.parametrize("conditional", [False, True], ids=["unconditional", "conditional"])
@pytest.mark.parametrize("name", SDES)
@pytest.mark.parametrize("predictor", PREDICTORS)
def test_predictor_step_matches_jax(predictor, name, conditional):
    jsde, tsde = sde_pair(name)
    jscore, tscore = analytic_scores(conditional)
    x, y, t = step_inputs(name)
    key = jax.random.key(7)
    jname = predictor if predictor != "none" else "none_predictor"
    kw_j = dict(sde=jsde, score_fn=jscore, y=jnp.asarray(y) if conditional else None)
    draws = [] if predictor == "none" else [jax.random.normal(key, x.shape)]
    noise = Replay(draws)
    tname = f"conditional_{predictor}" if conditional else predictor

    def port():
        return get_predictor(tname)(
            noise, torch.from_numpy(x), torch.from_numpy(t), sde=tsde, score_fn=tscore,
            y=torch.from_numpy(y) if conditional else None,
        )

    if predictor == "ancestral_sampling" and name == "subvpsde":  # no sub-VP branch in either
        with pytest.raises(NotImplementedError):
            getattr(jax_predictors, jname)(key, jnp.asarray(x), jnp.asarray(t), **kw_j)
        with pytest.raises(NotImplementedError, match="subVPSDE"):
            port()
        return
    want = getattr(jax_predictors, jname)(key, jnp.asarray(x), jnp.asarray(t), **kw_j)
    got = port()
    assert not noise.draws
    for g, w in zip(got, want):
        close(g, w)


CORRECTORS = ["langevin", "ald", "none"]


@pytest.mark.parametrize("conditional", [False, True], ids=["unconditional", "conditional"])
@pytest.mark.parametrize("name", SDES)
@pytest.mark.parametrize("corrector", CORRECTORS)
def test_corrector_step_matches_jax(corrector, name, conditional):
    """Two corrector steps; under VP the step size carries alphas[timestep]."""
    jsde, tsde = sde_pair(name)
    jscore, tscore = analytic_scores(conditional)
    x, y, t = step_inputs(name)
    key = jax.random.key(9)
    jname = {"langevin": "langevin", "ald": "annealed_langevin", "none": "none_corrector"}[corrector]
    kw = dict(snr=0.16, n_steps=2)
    want = getattr(jax_correctors, jname)(
        key, jnp.asarray(x), jnp.asarray(t), sde=jsde, score_fn=jscore,
        y=jnp.asarray(y) if conditional else None, **kw,
    )
    draws = [] if corrector == "none" else [jax.random.normal(jax.random.fold_in(key, i), x.shape) for i in range(2)]
    noise = Replay(draws)
    tname = f"conditional_{corrector}" if conditional else corrector
    got = get_corrector(tname)(
        noise, torch.from_numpy(x), torch.from_numpy(t), sde=tsde, score_fn=tscore,
        y=torch.from_numpy(y) if conditional else None, **kw,
    )
    assert not noise.draws
    for g, w in zip(got, want):
        close(g, w)


def test_vp_langevin_step_carries_alpha():
    """Under VP the Langevin step is the VE one times alphas[timestep], the
    timestep truncated: at t = 0.73 and N = 1000, step 729."""
    _, tsde = sde_pair("vpsde")
    _, tscore = analytic_scores(False)
    x, _, t = step_inputs("vpsde")
    z = torch.from_numpy(np.random.RandomState(4).randn(*x.shape).astype(np.float32))
    args = (torch.from_numpy(x), torch.from_numpy(t))
    kw = dict(score_fn=tscore, snr=0.16, n_steps=1)
    _, vp_mean = get_corrector("langevin")(Replay([z.numpy()]), *args, sde=tsde, **kw)
    _, ve_mean = get_corrector("langevin")(Replay([z.numpy()]), *args, sde=VESDE(), **kw)
    step_vp, step_ve = (m - args[0] for m in (vp_mean, ve_mean))
    alpha = tsde.alphas("cpu")[torch.tensor([729, 0])]
    # x_mean - x rounds at x's scale: held at 1e-5 of the largest step
    torch.testing.assert_close(step_vp, step_ve * alpha[:, None, None, None], rtol=1e-5, atol=1e-5 * step_ve.abs().max().item())
    assert alpha[0] < 1.0


def test_ancestral_sampling_refuses_probability_flow():
    _, tsde = sde_pair("vpsde")
    x, _, t = step_inputs("vpsde")
    with pytest.raises(ValueError, match="probability flow"):
        get_predictor("ancestral_sampling")(
            Replay([]), torch.from_numpy(x), torch.from_numpy(t), sde=tsde,
            score_fn=analytic_scores(False)[1], probability_flow=True,
        )
