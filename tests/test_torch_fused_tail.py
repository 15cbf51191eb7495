"""The port's fused GroupNorm+SiLU+conv3x3 tail (plain version, the path a
CPU tensor takes) against the JAX Pallas kernel in interpret mode and the
JAX reference composition, on the same numpy inputs.

Tolerance 2e-5 (absolute and relative): the bound the JAX package holds its
fused tail to against the unfused one (`models/layers.py:191-195`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conditional_score_diffusion_tpu.ops import fused_block_pallas as jax_fused
from conditional_score_diffusion_tpu_torch.ops import fused_tail

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)

# (Cin, Cout, groups, H): the toy model's two gated levels, a tiny-group
# case, an odd image side, and Cin != Cout.
CASES = [(32, 32, 32, 16), (64, 64, 32, 8), (48, 48, 16, 5), (64, 48, 32, 6)]
EXTRAS = [(False, False), (True, False), (True, True)]


def _inputs(cin, cout, h, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, h, h, cin).astype(np.float32) * 1.5 + 0.3
    w = (rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)  # HWIO
    gamma = (1.0 + 0.1 * rng.randn(cin)).astype(np.float32)
    beta = (0.1 * rng.randn(cin)).astype(np.float32)
    bias = (0.1 * rng.randn(cout)).astype(np.float32)
    temb = rng.randn(2, cout).astype(np.float32)
    return x, w, gamma, beta, bias, temb


@pytest.mark.parametrize("with_bias,with_temb", EXTRAS)
@pytest.mark.parametrize("cin,cout,groups,h", CASES)
def test_fused_tail_matches_jax(cin, cout, groups, h, with_bias, with_temb):
    x, w, gamma, beta, bias, temb = _inputs(cin, cout, h, seed=cin + h)
    bias = bias if with_bias else None
    temb = temb if with_temb else None

    j = lambda a: None if a is None else jnp.asarray(a)
    want_pallas = np.asarray(
        jax_fused.gn_silu_conv3x3_nhwc(
            j(x), j(w), j(gamma), j(beta), groups, bias=j(bias), temb=j(temb), interpret=True
        )
    )
    want_ref = np.asarray(
        jax_fused.gn_silu_conv3x3_reference(j(x), j(w), j(gamma), j(beta), groups, bias=j(bias), temb=j(temb))
    )

    t = lambda a: None if a is None else torch.from_numpy(a)
    launches = fused_tail.gn_silu_conv3x3.launches
    got = fused_tail.gn_silu_conv3x3(
        t(x), t(np.ascontiguousarray(w.transpose(3, 2, 0, 1))), t(gamma), t(beta), groups,
        bias=t(bias), temb=t(temb),
    )
    assert fused_tail.gn_silu_conv3x3.launches == launches  # CPU: no kernel launch
    assert got.shape == (2, h, h, cout) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_pallas, **TOL)
    np.testing.assert_allclose(got.numpy(), want_ref, **TOL)


@pytest.mark.parametrize("cin,groups", [(32, 32), (48, 16), (288, 32)])
def test_group_norm_stats_matches_jax(cin, groups):
    x = np.random.RandomState(cin).randn(2, 5, 7, cin).astype(np.float32) * 2 + 1
    mean, rstd = fused_tail.group_norm_stats(torch.from_numpy(x), groups)
    # the JAX function takes the (H, W, B, C) layout
    jmean, jrstd = jax_fused.group_norm_stats(jnp.asarray(x.transpose(1, 2, 0, 3)), groups)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd), rtol=1e-5, atol=1e-6)


def test_wrapper_refuses_other_devices():
    x = torch.empty(1, 4, 4, 32, device="meta")
    w = torch.empty(32, 32, 3, 3, device="meta")
    g = torch.empty(32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_tail.gn_silu_conv3x3(x, w, g, g, 32)
