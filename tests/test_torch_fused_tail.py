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
import torch.nn.functional as F
from _torch_port_splitk import check_plan, split_k_conv

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


# ---- the launch plan and its split-K partition (csrc/conv3x3_core.cuh) --------


def _sampler_tail_shapes():
    """(B, H, C) of every tail call on the four sampler paths: the float32
    flagship (17 a forward) and the bf16 block path (its 5 at 20x20) at B=8,
    the NCSN++ block variant at B=8, the texture64 harness at B=16 (counted
    on the meta device)."""
    import chip_smoke

    shapes = {(chip_smoke.BATCH, h, c) for h, c, *_ in chip_smoke.TAIL_SHAPES}
    shapes |= {(chip_smoke.BATCH, h, c) for h, c in chip_smoke.NCSNPP_TAIL_SHAPES}
    harness = chip_smoke.sites(
        chip_smoke.forward_calls(chip_smoke.harness_config(""), chip_smoke.HARNESS_BATCH), "gn_silu_conv3x3"
    )
    assert sum(harness.values()) == 17
    shapes |= {(chip_smoke.HARNESS_BATCH, h, c) for h, c in harness}
    return sorted(shapes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_plan_at_every_sampler_tail_shape(dtype):
    shapes = _sampler_tail_shapes()
    assert len(shapes) == 3 + 5 + 3  # the flagship's, NCSN++'s and the harness's distinct shapes
    for B, h, c in shapes:
        plan = check_plan(B * h * h, c, c, dtype)
        assert plan.splits > 1 and plan.a_vec == 1 and plan.b_vec == 1, (B, h, c)


# (B, H, Cin, Cout, groups): 4x4 images, a ragged M (3 * 5 * 5 = 75), Cout = 6.
SPLIT_CASES = [(4, 4, 64, 64, 32), (3, 5, 48, 40, 16), (2, 6, 32, 6, 8)]


@pytest.mark.parametrize("B,h,cin,cout,groups", SPLIT_CASES)
def test_split_k_emulation_matches_plain(B, h, cin, cout, groups):
    """The activation (float32 GroupNorm, SiLU) through per-split partial
    convs over the plan's K ranges, summed in rank order, + bias + temb,
    equals `gn_silu_conv3x3_plain` within 1e-6 (float32)."""
    rng = np.random.RandomState(h + cin)
    x = torch.from_numpy(rng.randn(B, h, h, cin).astype(np.float32) * 1.5 + 0.3)
    w = torch.from_numpy((rng.randn(cout, cin, 3, 3) / np.sqrt(9 * cin)).astype(np.float32))
    gamma, beta = (torch.from_numpy(v.astype(np.float32)) for v in (1 + 0.1 * rng.randn(cin), 0.1 * rng.randn(cin)))
    bias, temb = torch.from_numpy(0.1 * rng.randn(cout).astype(np.float32)), torch.from_numpy(
        rng.randn(B, cout).astype(np.float32))
    mean, rstd = fused_tail.group_norm_stats(x, groups)
    scale = rstd * gamma
    act = F.silu(x * scale[:, None, None, :] + (beta - mean * scale)[:, None, None, :])
    plan = check_plan(B * h * h, cin, cout, torch.float32)
    assert plan.splits > 1
    got = split_k_conv(act, w, plan, bias, temb)
    want = fused_tail.gn_silu_conv3x3_plain(x, w, gamma, beta, groups, bias=bias, temb=temb)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()


def test_packed_weight_is_kept_per_weight_version():
    """The tail's repacked (3, 3, Cin, Cout) weight is made once per weight
    and made anew after an in-place update; the entry goes with the weight."""
    import gc

    from conditional_score_diffusion_tpu_torch.ops.conv3x3 import hwio

    w = torch.randn(6, 4, 3, 3)
    first = fused_tail._packed_weight(w)
    assert fused_tail._packed_weight(w) is first and torch.equal(first, hwio(w))
    with torch.no_grad():
        w.mul_(2.0)
    second = fused_tail._packed_weight(w)
    assert second is not first and torch.equal(second, hwio(w))
    key = id(w)
    del w
    gc.collect()
    assert key not in fused_tail._PACKED


def test_packed_weight_follows_a_module_conversion():
    """`nn.Module.to` swaps a parameter's data in place (same object, same
    version counter): the cached repack must not survive it."""
    from conditional_score_diffusion_tpu_torch.ops.conv3x3 import hwio

    conv = torch.nn.Conv2d(4, 6, 3)
    w = conv.weight
    first = fused_tail._packed_weight(w)
    version = w._version
    conv.to(torch.bfloat16)
    assert conv.weight is w and w._version == version  # what a key on (id, version) alone would miss
    second = fused_tail._packed_weight(conv.weight)
    assert second.dtype == torch.bfloat16 and torch.equal(second, hwio(conv.weight))
    assert first.dtype == torch.float32
