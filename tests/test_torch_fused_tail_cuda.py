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

from conditional_score_diffusion_tpu_torch.ops import fused_tail

# The flagship sampler's gated tails: (H, C) at B=8, 32 groups.
SHAPES = [(20, 192), (10, 288), (5, 288)]
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(h, c, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(8, h, h, c, generator=g, device=device) * 1.5 + 0.3).to(dtype)
    w = (torch.randn(c, c, 3, 3, generator=g, device=device) / (9 * c) ** 0.5).to(dtype)
    gamma = 1.0 + 0.1 * torch.randn(c, generator=g, device=device)
    beta = 0.1 * torch.randn(c, generator=g, device=device)
    bias = 0.1 * torch.randn(c, generator=g, device=device)
    temb = torch.randn(8, c, generator=g, device=device)
    return x, w, gamma, beta, bias, temb


@pytest.mark.cuda
@pytest.mark.parametrize("with_temb", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,c", SHAPES)
def test_kernel_matches_plain(device, h, c, dtype, with_temb):
    x, w, gamma, beta, bias, temb = _inputs(h, c, dtype, device, seed=h * c)
    temb = temb if with_temb else None
    launches = fused_tail.gn_silu_conv3x3.launches
    got = fused_tail.gn_silu_conv3x3(x, w, gamma, beta, 32, bias=bias, temb=temb)
    torch.cuda.synchronize()
    assert fused_tail.gn_silu_conv3x3.launches == launches + 1
    want = fused_tail.gn_silu_conv3x3_plain(x, w, gamma, beta, 32, bias=bias, temb=temb)
    assert got.shape == want.shape and got.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= REL_TOL[dtype] * want.float().abs().max().item(), err


@pytest.mark.cuda
def test_kernel_refuses_bad_input(device):
    x, w, gamma, beta, bias, _ = _inputs(10, 288, torch.float32, device, seed=0)
    with pytest.raises(ValueError, match="contiguous"):
        fused_tail.gn_silu_conv3x3(x.transpose(1, 2), w, gamma, beta, 32)
    with pytest.raises(TypeError):
        fused_tail.gn_silu_conv3x3(x, w.to(torch.bfloat16), gamma, beta, 32)
    with pytest.raises(ValueError, match="groups"):
        fused_tail.gn_silu_conv3x3(x, w, gamma, beta, 7)
