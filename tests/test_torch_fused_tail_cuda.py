"""The fused-tail CUDA kernel against its plain PyTorch version, on the card.

Marked ``cuda``: it skips where there is no CUDA device.  This file imports
neither JAX nor the JAX package, so it runs on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_fused_tail_cuda.py

Tolerances: float32 1e-4 of the output's largest magnitude (float32 sums in
another order than cuDNN's; TF32 is off on the plain side); bfloat16 2e-2
(both sides round the activation and the output to bfloat16).
"""

import pytest
import torch

import chip_smoke
from conditional_score_diffusion_tpu_torch.models.layers import legacy_num_groups
from conditional_score_diffusion_tpu_torch.ops import conv3x3, fused_tail

# The gated tails, 32 groups: (B, H, C): the flagship sampler's at B=8, the
# texture64 harness's at B=16, the NCSN++ block variant's at B=8; and a
# ragged M (3 x 5x5) with Cout = 6 (`CASES`, with its own groups).
SHAPES = [(8, 20, 192), (8, 10, 288), (8, 5, 288), (16, 16, 128), (16, 8, 128), (16, 4, 192), (8, 20, 128),
          (8, 10, 256), (8, 5, 256)]
CASES = [(3, 5, 48, 6, 16), (3, 7, 32, 32, 8)]
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(h, c, dtype, device, seed, batch=8, cout=None):
    cout = cout or c
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(batch, h, h, c, generator=g, device=device) * 1.5 + 0.3).to(dtype)
    w = (torch.randn(cout, c, 3, 3, generator=g, device=device) / (9 * c) ** 0.5).to(dtype)
    gamma = 1.0 + 0.1 * torch.randn(c, generator=g, device=device)
    beta = 0.1 * torch.randn(c, generator=g, device=device)
    bias = 0.1 * torch.randn(cout, generator=g, device=device)
    temb = torch.randn(batch, cout, generator=g, device=device)
    return x, w, gamma, beta, bias, temb


def _check(got, want, dtype):
    assert got.shape == want.shape and got.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= REL_TOL[dtype] * want.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("with_temb", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,c", SHAPES)
def test_kernel_matches_plain(device, b, h, c, dtype, with_temb):
    x, w, gamma, beta, bias, temb = _inputs(h, c, dtype, device, seed=h * c, batch=b)
    temb = temb if with_temb else None
    launches = fused_tail.gn_silu_conv3x3.launches
    got = fused_tail.gn_silu_conv3x3(x, w, gamma, beta, 32, bias=bias, temb=temb)
    torch.cuda.synchronize()
    assert fused_tail.gn_silu_conv3x3.launches == launches + 1
    _check(got, fused_tail.gn_silu_conv3x3_plain(x, w, gamma, beta, 32, bias=bias, temb=temb), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("with_temb", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,c", chip_smoke.CHAIN_TAIL_SHAPES)
def test_kernel_matches_plain_at_the_chain_sites(device, h, c, dtype, with_temb):
    """The multi-scale chains' tails (B=8) with the DDPM's groups: 16 groups
    of 3 at C = 48, 32 groups of 3 and of 4 at C = 96 and 128."""
    g = legacy_num_groups(c)
    x, w, gamma, beta, bias, temb = _inputs(h, c, dtype, device, seed=h * c + 3)
    temb = temb if with_temb else None
    _check(fused_tail.gn_silu_conv3x3(x, w, gamma, beta, g, bias=bias, temb=temb),
           fused_tail.gn_silu_conv3x3_plain(x, w, gamma, beta, g, bias=bias, temb=temb), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,cin,cout,groups", CASES)
def test_kernel_matches_plain_off_the_model_widths(device, b, h, cin, cout, groups, dtype):
    x, w, gamma, beta, bias, temb = _inputs(h, cin, dtype, device, seed=cin + cout, batch=b, cout=cout)
    _check(fused_tail.gn_silu_conv3x3(x, w, gamma, beta, groups, bias=bias, temb=temb),
           fused_tail.gn_silu_conv3x3_plain(x, w, gamma, beta, groups, bias=bias, temb=temb), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,c", [(8, 5, 288), (16, 8, 128), (8, 20, 192)])
def test_split_k_is_deterministic_and_agrees_unsplit(device, b, h, c, dtype, monkeypatch):
    """A split shape: two launches are bit-identical, and the unsplit plan
    agrees within the tolerance."""
    x, w, gamma, beta, bias, temb = _inputs(h, c, dtype, device, seed=c + h, batch=b)
    assert conv3x3.launch_plan(b * h * h, c, c, dtype).splits > 1
    first, second = (fused_tail.gn_silu_conv3x3(x, w, gamma, beta, 32, bias=bias, temb=temb) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    monkeypatch.setattr(conv3x3, "MAX_SPLITS", 1)
    _check(first, fused_tail.gn_silu_conv3x3(x, w, gamma, beta, 32, bias=bias, temb=temb), dtype)


@pytest.mark.cuda
def test_kernel_refuses_bad_input(device):
    x, w, gamma, beta, bias, _ = _inputs(10, 288, torch.float32, device, seed=0)
    with pytest.raises(ValueError, match="contiguous"):
        fused_tail.gn_silu_conv3x3(x.transpose(1, 2), w, gamma, beta, 32)
    with pytest.raises(TypeError):
        fused_tail.gn_silu_conv3x3(x, w.to(torch.bfloat16), gamma, beta, 32)
    with pytest.raises(ValueError, match="groups"):
        fused_tail.gn_silu_conv3x3(x, w, gamma, beta, 7)
