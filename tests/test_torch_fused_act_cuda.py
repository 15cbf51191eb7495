"""The fused bias + leaky ReLU CUDA kernel (`csrc/fused_bias_act.cu`, TPU
kernel 8) against its plain PyTorch version, on the card.

Marked ``cuda``: it skips where there is no CUDA device.  This file imports
neither JAX nor the JAX package, so it runs on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_fused_act_cuda.py

Tolerances: float32 1e-6 of the largest magnitude (the same float32
operations in the same order; in practice equal); bfloat16 two bfloat16
steps of each element (both round once from float32).
"""

import pytest
import torch

from chip_smoke import FUSED_ACT_SHAPES
from conditional_score_diffusion_tpu_torch.ops import fused_act


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check(got, want, dtype):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype == dtype
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()
    else:
        mag = torch.maximum(got.float().abs(), want.float().abs()).clamp_min(1e-30)
        assert torch.all((got.float() - want.float()).abs() <= 2 * torch.exp2(torch.floor(torch.log2(mag)) - 7))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,with_bias,slope,scale", FUSED_ACT_SHAPES + [((5, 4), True, 0.2, 2**0.5)])
def test_kernel_matches_plain(device, shape, with_bias, slope, scale, dtype):
    g = torch.Generator(device=device).manual_seed(sum(shape))
    x = torch.randn(shape, generator=g, device=device).to(dtype)
    b = torch.randn(shape[-1], generator=g, device=device).to(dtype) if with_bias else None
    launches = fused_act.fused_leaky_relu_kernel.launches
    got = fused_act.fused_leaky_relu(x, b, slope, scale)
    assert fused_act.fused_leaky_relu_kernel.launches == launches + 1
    _check(got, fused_act.fused_leaky_relu_plain(x, b, slope, scale), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unaligned_and_strided_inputs(device, dtype):
    """A view that starts off the vector alignment and a transposed x both
    take the scalar or contiguous path and agree with plain."""
    base = torch.randn(4 * 8 * 16 + 1, device=device).to(dtype)
    x = base[1:].view(4, 8, 16)
    b = torch.randn(17, device=device).to(dtype)[1:]
    _check(fused_act.fused_leaky_relu(x, b), fused_act.fused_leaky_relu_plain(x, b), dtype)
    xt = torch.randn(16, 8, 4, device=device).to(dtype).transpose(0, 2)
    _check(fused_act.fused_leaky_relu(xt, b), fused_act.fused_leaky_relu_plain(xt, b), dtype)


@pytest.mark.cuda
def test_gradient_matches_plain_autograd(device):
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(2, 6, 6, 8, generator=g, device=device)
    b = torch.randn(8, generator=g, device=device)
    up = torch.randn(2, 6, 6, 8, generator=g, device=device)
    xk, bk = x.clone().requires_grad_(), b.clone().requires_grad_()
    (fused_act.fused_leaky_relu(xk, bk) * up).sum().backward()
    xp, bp = x.clone().requires_grad_(), b.clone().requires_grad_()
    (fused_act.fused_leaky_relu_plain(xp, bp) * up).sum().backward()
    torch.testing.assert_close(xk.grad, xp.grad, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(bk.grad, bp.grad, rtol=1e-5, atol=1e-5)
