"""The 3x3 conv CUDA kernel (TPU kernels 4 and 5) against its plain PyTorch
version, on the card.

Marked ``cuda``: it skips where there is no CUDA device.  This file imports
neither JAX nor the JAX package, so it runs on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_conv3x3_cuda.py

At the flagship train step's shapes (B=16; every distinct forward and dx
shape is in `chip_smoke.py`), forward, the autograd input gradient (the
same kernel on rotated weights) against `F.conv2d`'s, and the (H, W, B, C)
entry.  Tolerances: float32 1e-4 of the largest magnitude (sums in another
order than cuDNN's; TF32 off); bfloat16 2e-2 (both round the output once).
"""

import pytest
import torch
import torch.nn.functional as F

from conditional_score_diffusion_tpu_torch.ops import conv3x3 as ops

# (H, Cin, Cout) at B=16: the 160x160 convs (the input conv, the 96-channel
# convs and the output conv), 80x80 with 192 in, 20x20 288 -> 192, the 10x10
# convs, 5x5 (split 8 ways); CDE's 3-channel output conv and its dx.
SHAPES = [(160, 6, 96), (160, 96, 96), (160, 96, 6), (80, 192, 96), (20, 288, 192), (10, 192, 288),
          (10, 288, 288), (5, 288, 288), (160, 96, 3), (160, 3, 96)]
# (B, H, W, Cin, Cout) off the flagship's widths: Cin = 6 and Cout = 6 on
# ragged M (3 * 7 * 5 pixels), an odd channel count (one-element copies in
# both operands), 4x4 images.
SMALL_SHAPES = [(3, 7, 5, 6, 6), (3, 7, 5, 6, 40), (2, 9, 9, 13, 20), (16, 4, 4, 192, 192)]
SPLIT_SHAPES = [(5, 288, 288), (10, 288, 192), (16, 128, 128)]
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(h, cin, cout, dtype, device, seed, batch=16, w=None):
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(batch, h, w or h, cin, generator=g, device=device) * 1.5 + 0.3).to(dtype)
    w = (torch.randn(cout, cin, 3, 3, generator=g, device=device) / (9 * cin) ** 0.5).to(dtype)
    bias = 0.1 * torch.randn(cout, generator=g, device=device)
    return x, w, bias


def _check(got, want, dtype):
    assert got.shape == want.shape and got.dtype == want.dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= REL_TOL[dtype] * want.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,cin,cout", SHAPES)
def test_kernel_matches_plain(device, h, cin, cout, dtype):
    x, w, bias = _inputs(h, cin, cout, dtype, device, seed=h * cin + cout)
    launches = ops.conv3x3.launches
    got = ops.conv3x3(x, w, bias)
    torch.cuda.synchronize()
    assert ops.conv3x3.launches == launches + 1
    _check(got, ops.conv3x3_plain(x, w, bias), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,cin,cout", SMALL_SHAPES)
def test_kernel_matches_plain_off_the_flagship_widths(device, b, h, w, cin, cout, dtype):
    x, wt, bias = _inputs(h, cin, cout, dtype, device, seed=cin * cout, batch=b, w=w)
    _check(ops.conv3x3(x, wt, bias), ops.conv3x3_plain(x, wt, bias), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,cin,cout", SPLIT_SHAPES)
def test_split_k_is_deterministic_and_agrees_unsplit(device, h, cin, cout, dtype, monkeypatch):
    """A split shape: two launches are bit-identical (the cluster sums the
    partial tiles in rank order), and the unsplit plan agrees within the
    tolerance."""
    x, w, bias = _inputs(h, cin, cout, dtype, device, seed=h + cin)
    assert ops.launch_plan(16 * h * h, cin, cout, dtype).splits > 1
    first, second = ops.conv3x3(x, w, bias), ops.conv3x3(x, w, bias)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    monkeypatch.setattr(ops, "MAX_SPLITS", 1)
    assert ops.launch_plan(16 * h * h, cin, cout, dtype).splits == 1
    _check(first, ops.conv3x3(x, w, bias), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("h,cin,cout", [(160, 96, 6), (160, 96, 3), (40, 96, 192), (10, 288, 192)])
def test_input_gradient_matches_conv2d(device, h, cin, cout):
    """The backward's dx (one more launch: the kernel on the output gradient
    with the weights rotated and Cin/Cout swapped) against F.conv2d's, on
    non-symmetric weights; dW and db as cuDNN's."""
    x, w, bias = _inputs(h, cin, cout, torch.float32, device, seed=cin)
    g = torch.randn(16, h, h, cout, device=device)
    xk, wk, bk = (t.clone().requires_grad_() for t in (x, w, bias))
    launches = ops.conv3x3.launches
    ops.conv3x3(xk, wk, bk).backward(g)
    torch.cuda.synchronize()
    assert ops.conv3x3.launches == launches + 2
    xr, wr, br = (t.clone().requires_grad_() for t in (x, w, bias))
    F.conv2d(xr.permute(0, 3, 1, 2), wr, br, padding=1).permute(0, 2, 3, 1).backward(g)
    for got, want in ((xk.grad, xr.grad), (wk.grad, wr.grad), (bk.grad, br.grad)):
        _check(got, want, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,cin,cout", [(20, 192, 192), (5, 288, 288)])
def test_hmajor_entry_matches_plain(device, h, cin, cout, dtype):
    x, w, bias = _inputs(h, cin, cout, dtype, device, seed=3 * h)
    xt = x.permute(1, 2, 0, 3).contiguous()
    launches = ops.conv3x3_hmajor.launches
    got = ops.conv3x3_hmajor(xt, w, bias)
    torch.cuda.synchronize()
    assert ops.conv3x3_hmajor.launches == launches + 1
    _check(got, ops.conv3x3_hmajor_plain(xt, w, bias), dtype)
    _check(got.permute(2, 0, 1, 3), ops.conv3x3(x, w, bias), dtype)


@pytest.mark.cuda
def test_kernel_refuses_bad_input(device):
    x, w, bias = _inputs(10, 32, 16, torch.float32, device, seed=0)
    with pytest.raises(ValueError, match="contiguous"):
        ops.conv3x3(x.transpose(1, 2), w)
    with pytest.raises(TypeError):
        ops.conv3x3(x, w.to(torch.bfloat16))
    with pytest.raises(ValueError, match="is on"):
        ops.conv3x3(x, w.cpu())
    with pytest.raises(TypeError):
        ops.conv3x3(x, w, bias.to(torch.bfloat16))
