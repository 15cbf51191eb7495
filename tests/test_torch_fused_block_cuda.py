"""The whole-resblock CUDA kernels against their plain PyTorch versions, on
the card.

Marked ``cuda``: it skips where there is no CUDA device.  This file imports
neither JAX nor the JAX package, so it runs on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_fused_block_cuda.py

Tolerances: float32 1e-4 of the output's largest magnitude (float32 sums in
another order than cuDNN's; TF32 is off on the plain side); bfloat16 2e-2
(both sides round the activations and the output to bfloat16, and a float32
sum that lands on the other side of a rounding boundary moves an activation
by one bfloat16 step).
"""

import pytest
import torch

import chip_smoke
from chip_smoke import block_call as run
from chip_smoke import block_inputs
from conditional_score_diffusion_tpu_torch.models.layers import legacy_num_groups
from conditional_score_diffusion_tpu_torch.ops import conv3x3, fused_block

# The whole-block sites, 32 groups: (B, H, Ca, Cb, Cout); Cb = 0 is the
# block kernel, else the split kernel.  The flagship sampler's at B=8 (a NIN
# shortcut at 10x10 192->288; 15-channel groups, one straddling channel 288,
# at 10x10 288+192), the NCSN++ block variant's at B=8 (a 1x1-conv
# shortcut), the trained texture64 model's at B=16 (a 10-channel group
# straddling channel 192 at 4x4 192+128).
SHAPES = sorted(
    {(chip_smoke.BATCH, h, ca, cb, co) for _, h, ca, cb, co, _ in chip_smoke.BLOCK_SHAPES}
    | {(chip_smoke.BATCH, h, ca, cb, co) for _, h, ca, cb, co in chip_smoke.NCSNPP_BLOCK_SHAPES}
    | {(chip_smoke.HARNESS_BATCH, h, ca, cb, co) for _, h, ca, cb, co, _ in chip_smoke.TEXTURE64_BLOCK_SHAPES}
)
# Off the model widths, with their own groups: (B, H, Ca, Cb, Cout, G0,
# G1): ragged M (3 x 5 x 5 = 75) with a 5-channel group straddling channel
# 24 and a mix shortcut; the identity residual over a concat; Cout = 6 with
# a 12-channel mix shortcut (bfloat16 folded copies one element each,
# float32 weight rows not whole vectors).
CASES = [(3, 5, 24, 16, 32, 8, 8), (2, 5, 16, 16, 32, 8, 4), (3, 7, 12, 0, 6, 4, 2)]
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check(got, want, dtype):
    assert got.shape == want.shape and got.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= REL_TOL[dtype] * want.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("with_temb,skip_rescale", [(True, False), (False, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,ca,cb,cout", SHAPES)
def test_kernel_matches_plain(device, b, h, ca, cb, cout, dtype, with_temb, skip_rescale):
    x, skip, kw = block_inputs(h, ca, cb, cout, dtype, seed=h * (ca + cb), with_temb=with_temb, batch=b)
    kw["skip_rescale"] = skip_rescale
    counter = fused_block.resblock_fused if skip is None else fused_block.resblock_fused_split
    launches = counter.launches
    got = run(x, skip, kw)
    torch.cuda.synchronize()
    assert counter.launches == launches + 1
    want = run(x, skip, kw, plain=True)
    assert got.shape == (b, h, h, cout)
    _check(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("with_temb,skip_rescale", [(True, False), (False, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,h,ca,cb,cout", chip_smoke.CHAIN_BLOCK_SHAPES)
def test_kernel_matches_plain_at_the_chain_sites(device, name, h, ca, cb, cout, dtype, with_temb, skip_rescale):
    """The multi-scale chains' block sites (B=8) with the DDPM's groups: 16
    groups of 3 (C = 48) and of 9 (48 + 96, one straddling the concat), 32
    groups of 3 to 12."""
    x, skip, kw = block_inputs(h, ca, cb, cout, dtype, seed=h * (ca + cb) + 3, with_temb=with_temb)
    kw.update(num_groups0=legacy_num_groups(ca + cb), num_groups1=legacy_num_groups(cout), skip_rescale=skip_rescale)
    assert (skip is None) == (name == "resblock_fused")
    got = run(x, skip, kw)
    assert got.shape == (chip_smoke.BATCH, h, h, cout)
    _check(got, run(x, skip, kw, plain=True), dtype)


def _case_inputs(b, h, ca, cb, cout, g0, g1, dtype, with_temb=True):
    x, skip, kw = block_inputs(h, ca, cb, cout, dtype, seed=b * h + ca + cb, with_temb=with_temb, batch=b)
    kw.update(num_groups0=g0, num_groups1=g1)
    return x, skip, kw


@pytest.mark.cuda
@pytest.mark.parametrize("skip_rescale", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,ca,cb,cout,g0,g1", CASES)
def test_kernel_matches_plain_off_the_model_widths(device, b, h, ca, cb, cout, g0, g1, dtype, skip_rescale):
    x, skip, kw = _case_inputs(b, h, ca, cb, cout, g0, g1, dtype, with_temb=not skip_rescale)
    kw["skip_rescale"] = skip_rescale
    _check(run(x, skip, kw), run(x, skip, kw, plain=True), dtype)


@pytest.mark.cuda
def test_the_shortcut_may_be_a_transposed_view(device):
    """The model hands over ws as the transposed view of its (Cout, Cin)
    weight: the same output as a contiguous copy."""
    x, skip, kw = block_inputs(5, 288, 288, 288, torch.bfloat16, seed=3)
    ws = kw["shortcut_w"]
    view = ws.t().contiguous().t()
    assert not view.is_contiguous()
    assert torch.equal(run(x, skip, kw), run(x, skip, dict(kw, shortcut_w=view)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,ca,cb,cout", [(8, 5, 288, 288, 288), (8, 10, 192, 0, 288), (16, 4, 192, 128, 192)])
def test_split_k_is_deterministic_and_agrees_unsplit(device, b, h, ca, cb, cout, dtype, monkeypatch):
    """A split site: two calls are bit-identical (split-K sums in rank
    order, no float atomics), and the unsplit plans agree within the
    tolerance."""
    x, skip, kw = block_inputs(h, ca, cb, cout, dtype, seed=h + ca + cb, batch=b)
    plans = fused_block.block_plans(b, h, h, ca, cb, cout, dtype, ca + cb != cout)
    assert all(p.splits > 1 for p in plans)
    first, second = run(x, skip, kw), run(x, skip, kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    monkeypatch.setattr(conv3x3, "MAX_SPLITS", 1)
    assert all(p.splits == 1 for p in fused_block.block_plans(b, h, h, ca, cb, cout, dtype, ca + cb != cout))
    _check(run(x, skip, kw), first, dtype)


@pytest.mark.cuda
def test_kernel_refuses_bad_input(device):
    x, skip, kw = block_inputs(10, 288, 192, 288, torch.float32, seed=0)
    with pytest.raises(ValueError, match="contiguous"):
        fused_block.resblock_fused_split(x.transpose(1, 2), skip, **kw)
    with pytest.raises(TypeError):
        fused_block.resblock_fused_split(x.to(torch.bfloat16), skip.to(torch.bfloat16), **kw)
    with pytest.raises(TypeError):
        fused_block.resblock_fused_split(x, skip, **dict(kw, b0=kw["b0"].to(torch.bfloat16)))
    with pytest.raises(ValueError, match="is on"):
        fused_block.resblock_fused_split(x, skip.cpu(), **kw)
    with pytest.raises(ValueError, match="groups"):
        fused_block.resblock_fused_split(x, skip, **dict(kw, num_groups0=7))
