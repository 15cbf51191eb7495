"""The FIR resampling CUDA kernels against their plain PyTorch versions, on
the card: at the NCSN++ path's 20 calls, at inputs 4 bytes off an aligned
address (the vector narrows), 3 channels and odd H and W; and the routing
of `ops/upfirdn.py` (kernels without a gradient, plain versions with one).

Marked ``cuda``: it skips where there is no CUDA device.  This file imports
neither JAX nor the JAX package, so it runs on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_fir_cuda.py

Tolerances: float32 1e-5 of the output's largest magnitude (the same taps'
products summed in another order than cuDNN's depthwise conv; TF32 is off
on the plain side); bfloat16 2e-2 (both sides sum in float32 and round
once, so they differ by at most one bfloat16 step).
"""

import pytest
import torch

from chip_smoke import ASYMMETRIC_FIR, FIR_EXTRA_CASES, FIR_SHAPES
from conditional_score_diffusion_tpu_torch.ops import fir
from conditional_score_diffusion_tpu_torch.ops.upfirdn import downsample_2d, upsample_2d

REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check(got, want, dtype):
    assert got.shape == want.shape and got.dtype == want.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= REL_TOL[dtype] * want.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("k", [fir.FIR_KERNEL, ASYMMETRIC_FIR])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,h,c,calls", FIR_SHAPES)
def test_kernel_matches_plain(device, name, h, c, calls, dtype, k):
    g = torch.Generator(device=device).manual_seed(h * c)
    x = (torch.randn(8, h, h, c, generator=g, device=device) * 1.5 + 0.3).to(dtype)
    kernel = getattr(fir, name)
    launches = kernel.launches
    got = kernel(x, k)
    torch.cuda.synchronize()
    assert kernel.launches == launches + 1
    _check(got, getattr(fir, f"{name}_plain")(x, k), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,b,h,w,c,offset", FIR_EXTRA_CASES)
def test_offset_views_odd_shapes_and_three_channels(device, name, b, h, w, c, offset, dtype):
    """An input whose data starts ``offset`` bytes past an aligned address
    (the plan's vector narrows to 4 bytes), 3 channels, odd H and W."""
    item = torch.tensor([], dtype=dtype).element_size()
    skip = offset // item
    g = torch.Generator(device=device).manual_seed(h * w + c)
    buf = (torch.randn(b * h * w * c + skip, generator=g, device=device) * 1.5 + 0.3).to(dtype)
    x = buf[skip:].view(b, h, w, c)
    plan = fir.launch_plan(b, h, w, c, dtype, (x.data_ptr(), 0), down=name == "fir_downsample2")
    assert not offset or plan.vec * item == 4
    kernel = getattr(fir, name)
    launches = kernel.launches
    got = kernel(x)
    torch.cuda.synchronize()
    assert kernel.launches == launches + 1
    _check(got, getattr(fir, f"{name}_plain")(x), dtype)


@pytest.mark.cuda
def test_a_backward_takes_the_plain_versions(device):
    """With a gradient to carry, `upsample_2d` / `downsample_2d` launch no
    kernel and the gradient is the plain version's."""
    x = torch.randn(2, 12, 10, 8, device=device, requires_grad=True)
    up, down = fir.fir_upsample2.launches, fir.fir_downsample2.launches
    (upsample_2d(x, (1, 3, 3, 1), 2).square().sum() + downsample_2d(x, (1, 3, 3, 1), 2).square().sum()).backward()
    xp = x.detach().clone().requires_grad_()
    (fir.fir_upsample2_plain(xp).square().sum() + fir.fir_downsample2_plain(xp).square().sum()).backward()
    torch.cuda.synchronize()
    assert (fir.fir_upsample2.launches, fir.fir_downsample2.launches) == (up, down)
    _check(x.grad, xp.grad, torch.float32)


@pytest.mark.cuda
def test_resampling_routes_to_the_kernels(device):
    """`upsample_2d` / `downsample_2d` at factor 2 with 4 taps launch the
    kernels on a CUDA tensor, also on a non-contiguous one; other factors
    and kernels stay in `ops/upfirdn.py`."""
    x = torch.randn(2, 12, 12, 8, device=device).transpose(1, 2)
    up, down = fir.fir_upsample2.launches, fir.fir_downsample2.launches
    _check(upsample_2d(x, (1, 3, 3, 1), 2), fir.fir_upsample2_plain(x.contiguous()), torch.float32)
    _check(downsample_2d(x, (1, 3, 3, 1), 2), fir.fir_downsample2_plain(x.contiguous()), torch.float32)
    upsample_2d(x, (1, 3, 3, 1), 4)
    downsample_2d(x, (1, 1), 2)
    torch.cuda.synchronize()
    assert (fir.fir_upsample2.launches, fir.fir_downsample2.launches) == (up + 1, down + 1)


@pytest.mark.cuda
def test_wrappers_refuse_bad_arguments(device):
    x = torch.randn(2, 6, 6, 6, device=device)
    with pytest.raises(ValueError, match="even"):
        fir.fir_downsample2(x[:, :5, :5].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        fir.fir_upsample2(x.transpose(1, 2))
    with pytest.raises(TypeError):
        fir.fir_upsample2(x.half())
    with pytest.raises(ValueError, match="4-tap"):
        fir.fir_upsample2(x, (1, 2, 1))
