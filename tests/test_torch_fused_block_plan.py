"""The whole-resblock kernels' launch plans, their split-K partition and
their packed weights, on the CPU.

A block call is four launches (`csrc/resblock_fused.cu`): a GroupNorm+SiLU
pass, conv0 on the shared 3x3 main loop (`csrc/conv3x3_core.cuh`), the pass
again, and conv1 with the channel-mix shortcut folded into its K.  The plans
(`ops.fused_block.block_plans`) are held at every block site of the three
models that run the kernels, the sites themselves against `chip_smoke.py`'s
constants (counted on the meta device); the split-K sum of the four launches,
emulated in plain PyTorch (`_torch_port_splitk.split_k_block`), against the
plain versions at 1e-6 of the output's largest magnitude (float32: the same
products summed in another order); and the packed B operands against `hwio`
and the shortcut matrix, with their cache.
"""

import gc

import numpy as np
import pytest
import torch
from _torch_port_splitk import check_plan, split_k_block

from conditional_score_diffusion_tpu_torch.models import layers
from conditional_score_diffusion_tpu_torch.ops import conv3x3, fused_block
from conditional_score_diffusion_tpu_torch.ops.conv3x3 import hwio

torch.set_num_threads(1)


def _configs():
    """(batch, config) of each model that runs the block kernels: the bf16
    flagship, the NCSN++ block variant, the trained texture64 model with
    fused_block on."""
    import chip_smoke
    from conditional_score_diffusion_tpu_torch.configs import (
        texture160_kxsr_ncsnpp_block_config,
        texture160_sr_cmde_bf16_block_config,
    )

    texture64 = chip_smoke.harness_config("")
    texture64.model.fused_block = True
    return {
        "flagship": (chip_smoke.BATCH, texture160_sr_cmde_bf16_block_config()),
        "ncsnpp": (chip_smoke.BATCH, texture160_kxsr_ncsnpp_block_config()),
        "texture64": (chip_smoke.HARNESS_BATCH, texture64),
    }


def _sites(path):
    """The block sites of ``path``, counted on the meta device, as
    (batch, {(kernel, H, Ca, Cb, Cout): calls per forward}).  The NCSN++
    model takes a 40x40 y."""
    import chip_smoke

    batch, config = _configs()[path]
    inputs = None
    if path == "ncsnpp":
        meta = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
        inputs = {"x": meta(batch, 160, 160, 3), "y": meta(batch, 40, 40, 3)}
    calls = chip_smoke.forward_calls(config, batch, inputs)
    return batch, chip_smoke.sites(calls, "resblock_fused", "resblock_fused_split")


@pytest.mark.parametrize("path", ["flagship", "ncsnpp", "texture64"])
def test_block_sites_match_chip_smoke(path):
    """The sites `chip_smoke.py` checks and times are the ones each model
    calls, as often as it says."""
    import chip_smoke

    _, sites = _sites(path)
    if path == "flagship":
        assert sites == {(n, h, ca, cb, co): k for n, h, ca, cb, co, k in chip_smoke.BLOCK_SHAPES}
    elif path == "ncsnpp":
        assert set(sites) == set(chip_smoke.NCSNPP_BLOCK_SHAPES)
    else:
        assert sites == {(n, h, ca, cb, co): k for n, h, ca, cb, co, k in chip_smoke.TEXTURE64_BLOCK_SHAPES}
    assert sum(n for (name, *_), n in sites.items() if name == "resblock_fused_split") > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("path", ["flagship", "ncsnpp", "texture64"])
def test_launch_plans_at_every_block_site(path, dtype):
    """conv0 (K = 9 * Cin) and conv1 with the folded shortcut (K = 9 * Cout
    + Cin for a channel mix) at each site: whole chunks per split, K covered
    once, split over a cluster (no site fills the SMs with its tiles), 16-byte
    copies on both operands, no wasted output column, the shared memory
    within the SM's."""
    batch, sites = _sites(path)
    for name, h, ca, cb, cout in sites:
        cin, mix = ca + cb, ca + cb != cout
        plan0, plan1 = fused_block.block_plans(batch, h, h, ca, cb, cout, dtype, mix)
        M, extra = batch * h * h, cin if mix else 0
        assert plan0 == check_plan(M, cin, cout, dtype)
        assert plan1 == check_plan(M, cout, cout, dtype, extra=extra)
        for plan, K in ((plan0, 9 * cin), (plan1, 9 * cout + extra)):
            assert plan.nchunks == -(-K // plan.bk)
            assert plan.mtiles * plan.ntiles < conv3x3.SM_COUNT and plan.splits > 1, (name, h, ca, cb, plan)
            assert plan.a_vec == 1 and plan.b_vec == 1, (name, h, ca, cb, plan)
            assert plan.ntiles * plan.bn == cout, plan  # a tile width that wastes no column at these widths
            assert plan.smem <= conv3x3.SMEM_LIMIT


def test_folded_copies_are_scalar_where_a_half_is_not_whole_vectors():
    """The folded columns read x and skip at the output pixel: 16-byte copies
    only where both widths are whole vectors and both pointers aligned."""
    for dtype, ca in ((torch.float32, 6), (torch.bfloat16, 12)):
        _, plan1 = fused_block.block_plans(8, 5, 5, ca, 16, 32, dtype, mix=True)
        assert plan1.a_vec == 0
    _, plan1 = fused_block.block_plans(8, 5, 5, 16, 16, 32, torch.bfloat16, mix=True, inputs_aligned=False)
    assert plan1.a_vec == 0
    _, plan1 = fused_block.block_plans(8, 5, 5, 12, 20, 32, torch.bfloat16, mix=False, inputs_aligned=False)
    assert plan1.a_vec == 1  # no folded columns: conv1 reads only its scratch activation


def _block_args(B, h, ca, cb, cout, groups, mix, with_temb, skip_rescale, seed):
    rng = np.random.RandomState(seed)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa: E731
    cin = ca + cb
    x = t(B, h, h, ca) * 1.5 + 0.3
    skip = t(B, h, h, cb) - 0.5 if cb else None
    kw = dict(
        gamma0=1.0 + 0.1 * t(cin), beta0=0.1 * t(cin), num_groups0=groups[0],
        w0=t(cout, cin, 3, 3) / np.sqrt(9 * cin), b0=0.1 * t(cout), temb_proj=t(B, cout) if with_temb else None,
        gamma1=1.0 + 0.1 * t(cout), beta1=0.1 * t(cout), num_groups1=groups[1],
        w1=t(cout, cout, 3, 3) / np.sqrt(9 * cout), b1=0.1 * t(cout),
        # the transposed view of a (Cout, Cin) weight, as the model hands it over
        shortcut_w=(t(cout, cin) / np.sqrt(cin)).t() if mix else None,
        shortcut_b=0.1 * t(cout) if mix else None, skip_rescale=skip_rescale,
    )
    return x, skip, kw


# (B, H, Ca, Cb, Cout, (G0, G1), mix, temb, skip_rescale): a split with a
# 5-channel group straddling channel 24 and a mix shortcut; a split with the
# identity residual over the concat; a mix block; an identity block, ragged
# M (3 x 5 x 5 = 75); Cout = 6.
SPLIT_K_CASES = [
    (4, 4, 24, 16, 32, (8, 8), True, True, False),
    (2, 5, 16, 16, 32, (8, 4), False, False, True),
    (4, 5, 24, 0, 40, (4, 8), True, True, True),
    (3, 5, 32, 0, 32, (8, 8), False, True, False),
    (2, 6, 12, 0, 6, (4, 2), True, False, False),
]


@pytest.mark.parametrize("B,h,ca,cb,cout,groups,mix,with_temb,skip_rescale", SPLIT_K_CASES)
def test_split_k_emulation_matches_plain(B, h, ca, cb, cout, groups, mix, with_temb, skip_rescale):
    """The four launches' sums, each conv split over its plan's K ranges and
    added in rank order, equal `resblock_fused_plain` /
    `resblock_fused_split_plain` within 1e-6 (float32)."""
    x, skip, kw = _block_args(B, h, ca, cb, cout, groups, mix, with_temb, skip_rescale, seed=B * h + ca + cb)
    plan0, plan1 = fused_block.block_plans(B, h, h, ca, cb, cout, torch.float32, mix)
    assert plan0.splits > 1 and plan1.splits > 1
    got = split_k_block(x, skip, kw)
    if skip is None:
        want = fused_block.resblock_fused_plain(x, **kw)
    else:
        want = fused_block.resblock_fused_split_plain(x, skip, **kw)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()


def test_packed_conv1_layout():
    """conv1's B operand: row tap * Cout + c of (3, 3, Cout, Cout), then the
    shortcut's Cin rows; contiguous, from a strided shortcut view too."""
    w1, ws = torch.randn(6, 6, 3, 3), torch.randn(6, 10).t()
    packed = fused_block.pack_conv1(w1, ws)
    assert packed.shape == (9 * 6 + 10, 6) and packed.is_contiguous()
    assert torch.equal(packed[:54], hwio(w1).reshape(54, 6)) and torch.equal(packed[54:], ws)
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        assert torch.equal(packed[tap * 6:(tap + 1) * 6], w1[:, :, dy, dx].t())
    assert torch.equal(fused_block.pack_conv1(w1, None), hwio(w1).reshape(54, 6))


def test_packed_conv1_is_kept_per_weight_version():
    """The packed [w1 ; ws] is made once per weight, anew after an in-place
    update of w1 or of the shortcut weight (through the module's parameter,
    of which ws is a view), and its entry goes with w1."""
    w1 = torch.randn(6, 6, 3, 3)
    shortcut = torch.randn(6, 10)  # (Cout, Cin), as a NIN holds it
    first = fused_block._packed_conv1(w1, shortcut.t())
    assert fused_block._packed_conv1(w1, shortcut.t()) is first
    with torch.no_grad():
        shortcut.mul_(2.0)
    second = fused_block._packed_conv1(w1, shortcut.t())
    assert second is not first and torch.equal(second, fused_block.pack_conv1(w1, shortcut.t()))
    with torch.no_grad():
        w1.add_(1.0)
    third = fused_block._packed_conv1(w1, shortcut.t())
    assert third is not second and torch.equal(third, fused_block.pack_conv1(w1, shortcut.t()))
    assert fused_block._packed_conv1(w1, None).shape == (54, 6)  # the identity block's operand is another
    key = id(w1)
    del w1
    gc.collect()
    assert key not in fused_block._PACKED_CONV1


def test_block_args_pass_the_shortcut_without_a_copy():
    """The model hands the kernel the transposed view of its NIN weight (the
    wrapper packs it once), not a per-call contiguous copy."""
    block = layers.ResnetBlockDDPM(torch.nn.functional.silu, 16, 24, temb_dim=8, fused_block=True).eval()
    for dtype in (torch.float32, torch.bfloat16):
        block = block.to(dtype)
        ws = block.fused_block_args(dtype, None)["shortcut_w"]
        assert ws.shape == (16, 24) and ws.dtype == dtype
        assert ws.data_ptr() == block.shortcut.dense.weight.data_ptr()
