"""Every branch of the port's `get_score_fn` against the JAX function on
the same weights and inputs, at 5e-4 (the JAX package's bound for a
same-weights forward) of the score's largest magnitude.

Branches: conditional multi-speed with discrete labels (rounded t(N-1),
divided by each domain's sigma ladder); conditional VP and sub-VP on a
single SDE, continuous and discrete; conditional single VE with discrete
labels; unconditional VP and sub-VP, continuous and discrete;
unconditional VE, continuous (the network fed sigma(t), or log sigma(t)
under a Fourier embedding) and discrete (fed the ladder's sigma).
Conditional branches run the toy `ddpm_paired` / `ddpm_paired_SR3`
(32px), unconditional ones a 16px NCSN++.  On each branch ``params`` (the
module evaluated with other tensors) gives the score of a module holding
them, and a bfloat16 ``compute_dtype`` stays within 5e-2 by norm of the
float32 score.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_toy import (
    jax_init_params,
    jax_toy_params,
    ncsnpp_toy_config,
    reset_jax_dispatch,
    toy_inputs,
    train_toy_configs,
)
from conditional_score_diffusion_tpu.configs import base as jax_base
from conditional_score_diffusion_tpu.models.wrappers import get_score_fn as jax_get_score_fn
from conditional_score_diffusion_tpu.sde import VESDE as JaxVESDE
from conditional_score_diffusion_tpu.sde import VPSDE as JaxVPSDE
from conditional_score_diffusion_tpu.sde import build_sde as jax_build_sde
from conditional_score_diffusion_tpu.sde import subVPSDE as JaxSubVPSDE
from conditional_score_diffusion_tpu_torch.configs import base as torch_base
from conditional_score_diffusion_tpu_torch.models import create_model
from conditional_score_diffusion_tpu_torch.models.convert import flax_to_state_dict
from conditional_score_diffusion_tpu_torch.models.wrappers import get_score_fn
from conditional_score_diffusion_tpu_torch.sde import VESDE, VPSDE, build_sde, subVPSDE

torch.set_num_threads(1)

# t near the grid's ends and inside; t(N-1) is never near a half, so JAX's
# and torch's rounding agree by construction
T = np.array([0.7318, 0.0213], np.float32)


def single_sde(kind):
    return {
        "ve": (JaxVESDE(sigma_min=0.01, sigma_max=50.0, N=1000), VESDE(sigma_min=0.01, sigma_max=50.0, N=1000)),
        "vp": (JaxVPSDE(), VPSDE()),
        "subvp": (JaxSubVPSDE(), subVPSDE()),
    }[kind]


def conditional_case(kind):
    """The toy paired model and its SDEs: the multi-speed dict SDE of the
    CMDE recipe (kind "multispeed") or one SDE of ``kind`` on `ddpm_paired_SR3`."""
    jconfig, tconfig = train_toy_configs()
    if kind != "multispeed":
        for c in (jconfig, tconfig):
            c.model.name, c.model.output_channels = "ddpm_paired_SR3", 3
    module, params = jax_toy_params(jconfig, seed=3)
    if kind == "multispeed":
        sdes = jax_build_sde(jconfig)[0], build_sde(tconfig)[0]
    else:
        sdes = single_sde(kind)
    x, y, _ = toy_inputs(seed=4)
    return tconfig, module, params, sdes, {"x": x * 3.0, "y": y}


def unconditional_case(kind, embedding_type="positional"):
    jconfig, tconfig = ncsnpp_toy_config(jax_base, embedding_type), ncsnpp_toy_config(torch_base, embedding_type)
    module, params = jax_init_params(jconfig, seed=5)
    x = np.random.RandomState(6).randn(2, 16, 16, 3).astype(np.float32)
    return tconfig, module, params, single_sde(kind), x


CASES = [
    ("conditional", "multispeed", False, "positional"),
    ("conditional", "vp", True, "positional"),
    ("conditional", "vp", False, "positional"),
    ("conditional", "subvp", True, "positional"),
    ("conditional", "subvp", False, "positional"),
    ("conditional", "ve", False, "positional"),
    ("unconditional", "vp", True, "positional"),
    ("unconditional", "vp", False, "positional"),
    ("unconditional", "subvp", True, "positional"),
    ("unconditional", "subvp", False, "positional"),
    ("unconditional", "ve", True, "positional"),
    ("unconditional", "ve", True, "fourier"),
    ("unconditional", "ve", False, "positional"),
]


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()} if isinstance(tree, dict) else {"x": np.asarray(tree)}


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c)) for c in CASES])
def test_score_branch_matches_jax(case):
    kind, sde_kind, continuous, embedding_type = case
    conditional = kind == "conditional"
    make = conditional_case if conditional else unconditional_case
    args = (sde_kind,) if conditional else (sde_kind, embedding_type)
    tconfig, module, params, (jsde, tsde), inputs = make(*args)
    model = create_model(tconfig, device="cpu")
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()} if conditional else torch.from_numpy(inputs)
    tt = torch.from_numpy(T)
    try:
        jscore = jax_get_score_fn(jsde, module, params, conditional=conditional, train=False, continuous=continuous)
        jin = {k: jnp.asarray(v) for k, v in inputs.items()} if conditional else jnp.asarray(inputs)
        if conditional and sde_kind == "subvp" and not continuous:
            # sub-VP has no DDPM ladder: the discrete conditional score fails in both
            with pytest.raises(AttributeError, match="sqrt_1m_alphas_cumprod"):
                jscore(jin, jnp.asarray(T))
            with pytest.raises(AttributeError, match="sqrt_1m_alphas_cumprod"):
                get_score_fn(tsde, model, conditional=True, continuous=False)(tin, tt)
            return
        want = _np(jax.device_get(jscore(jin, jnp.asarray(T))))
    finally:
        reset_jax_dispatch()

    def score(**kw):
        fn = get_score_fn(tsde, model, conditional=conditional, train=False, continuous=continuous, **kw)
        return {k: v.float() for k, v in _np_torch(fn(tin, tt)).items()}

    got = score()
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=5e-4, atol=5e-4 * np.abs(w).max(), err_msg=k)

    # params: the module run with other tensors gives their module's score
    other = {n: p.detach() * 0.9 for n, p in model.named_parameters()}
    with_params = score(params=other)
    twin = create_model(tconfig, device="cpu")
    twin.load_state_dict({**model.state_dict(), **other})
    want_twin = {k: v.float() for k, v in _np_torch(
        get_score_fn(tsde, twin, conditional=conditional, train=False, continuous=continuous)(tin, tt)).items()}
    for k in want_twin:
        torch.testing.assert_close(with_params[k], want_twin[k], rtol=0, atol=0)
    # compute_dtype: a bfloat16 copy, float32 out
    low = score(compute_dtype=torch.bfloat16)
    for k in got:
        assert low[k].dtype == torch.float32
        assert ((low[k] - got[k]).norm() / got[k].norm()).item() < 5e-2, k


def _np_torch(out):
    return out if isinstance(out, dict) else {"x": out}


def test_unconditional_ve_feeds_sigma_not_labels():
    """The unconditional VE score feeds the network sigma(t), or log
    sigma(t) under a Fourier embedding, where a conditional one feeds
    t(N-1)."""
    seen = []

    class Probe(torch.nn.Module):
        def __init__(self, embedding_type):
            super().__init__()
            self.embedding_type = embedding_type

        def forward(self, x, labels):
            seen.append(labels)
            return torch.zeros_like(x)

    sde = VESDE(sigma_min=0.01, sigma_max=50.0, N=1000)
    x, t = torch.zeros(2, 4, 4, 3), torch.from_numpy(T)
    sigma = sde.marginal_prob(None, t)[1]
    for embedding_type, want in (("positional", sigma), ("fourier", torch.log(sigma))):
        get_score_fn(sde, Probe(embedding_type), continuous=True)(x, t)
        torch.testing.assert_close(seen.pop(), want, rtol=0, atol=0)
    get_score_fn(sde, Probe("positional"), continuous=False)(x, t)
    torch.testing.assert_close(seen.pop(), sde.discrete_sigmas("cpu")[torch.tensor([731, 21])], rtol=0, atol=0)
