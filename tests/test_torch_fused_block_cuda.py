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

from chip_smoke import block_call as run
from chip_smoke import block_inputs
from conditional_score_diffusion_tpu_torch.ops import fused_block

# The flagship sampler's whole-block sites at B=8, 32 groups:
# (H, Ca, Cb, Cout); Cb = 0 is the block kernel, else the split kernel.
SHAPES = [
    (10, 192, 0, 288),   # NIN shortcut
    (10, 288, 0, 288),
    (5, 288, 0, 288),
    (5, 288, 288, 288),
    (10, 288, 288, 288),
    (10, 288, 192, 288),  # 15-channel groups: one straddles channel 288
]
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("with_temb,skip_rescale", [(True, False), (False, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,ca,cb,cout", SHAPES)
def test_kernel_matches_plain(device, h, ca, cb, cout, dtype, with_temb, skip_rescale):
    x, skip, kw = block_inputs(h, ca, cb, cout, dtype, seed=h * (ca + cb), with_temb=with_temb)
    kw["skip_rescale"] = skip_rescale
    counter = fused_block.resblock_fused if skip is None else fused_block.resblock_fused_split
    launches = counter.launches
    got = run(x, skip, kw)
    torch.cuda.synchronize()
    assert counter.launches == launches + 1
    want = run(x, skip, kw, plain=True)
    assert got.shape == want.shape == (8, h, h, cout) and got.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= REL_TOL[dtype] * want.float().abs().max().item(), err


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
