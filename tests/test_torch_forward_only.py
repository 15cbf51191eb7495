"""The forward-only kernels' wrappers keep the autograd graph connected and
fail loudly on a backward (`ops/forward_only.py`), on the CPU as on the card:
the FIR resamplers (`ops/fir.py`), the fused tail (`ops/fused_tail.py`), the
whole-resblock kernels (`ops/fused_block.py`) and the (H, W, B, C) conv entry
(`ops/conv3x3.py`).  Without a gradient to carry (grad mode off, or no input
requiring grad) the call is the plain call, with no autograd node."""

import math

import jax  # noqa: F401  (the parity files import both frameworks)
import pytest
import torch

from conditional_score_diffusion_tpu_torch.ops import conv3x3, fir, fused_block, fused_tail

torch.set_num_threads(1)


def _block_kwargs(c, cout, requires_grad):
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    kw = dict(
        gamma0=1.0 + 0.1 * r(c), beta0=0.1 * r(c), num_groups0=8,
        w0=r(cout, c, 3, 3) / math.sqrt(9 * c), b0=0.1 * r(cout), temb_proj=r(2, cout),
        gamma1=1.0 + 0.1 * r(cout), beta1=0.1 * r(cout), num_groups1=8,
        w1=r(cout, cout, 3, 3) / math.sqrt(9 * cout), b1=0.1 * r(cout),
    )
    kw["w0"].requires_grad_(requires_grad)
    return kw


W_TAIL = torch.randn(16, 16, 3, 3, generator=torch.Generator().manual_seed(1)) * 0.1
W_HMAJOR = torch.randn(8, 16, 3, 3, generator=torch.Generator().manual_seed(2)) * 0.1
CALLS = {
    "fir_upsample2": lambda x: fir.fir_upsample2(x),
    "fir_downsample2": lambda x: fir.fir_downsample2(x),
    "gn_silu_conv3x3": lambda x: fused_tail.gn_silu_conv3x3(x, W_TAIL, torch.ones(16), torch.zeros(16), 8),
    "resblock_fused": lambda x: fused_block.resblock_fused(x, **_block_kwargs(16, 16, False)),
    "resblock_fused_split": lambda x: fused_block.resblock_fused_split(x, x * 0.5, **_block_kwargs(32, 32, False)),
    "conv3x3_hmajor": lambda x: conv3x3.conv3x3_hmajor(x, W_HMAJOR),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_backward_raises_instead_of_cutting_the_graph(name):
    x = torch.randn(2, 8, 8, 16, requires_grad=True)
    out = CALLS[name](x)
    assert out.requires_grad and out.grad_fn is not None
    with pytest.raises(NotImplementedError, match=f"{name} has no backward"):
        out.sum().backward()
    with torch.no_grad():
        plain = CALLS[name](x)
    assert plain.grad_fn is None and torch.equal(plain, out.detach())
    assert CALLS[name](x.detach()).grad_fn is None


def test_a_parameter_requiring_grad_is_enough():
    """The block's weights require grad, its input does not (an eval forward
    outside `no_grad`, as a test makes it): the guard still applies."""
    out = fused_block.resblock_fused(torch.randn(2, 8, 8, 16), **_block_kwargs(16, 16, True))
    with pytest.raises(NotImplementedError, match="eval-mode kernel"):
        out.sum().backward()


def test_the_fir_message_names_its_roadmap_item():
    out = fir.fir_upsample2(torch.randn(1, 4, 4, 6, requires_grad=True))
    with pytest.raises(NotImplementedError, match="ROADMAP.md section 3, FIR gradient"):
        out.sum().backward()
