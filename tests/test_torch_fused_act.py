"""The port's fused bias + leaky ReLU (`ops/fused_act.py`, TPU kernel 8)
against the JAX package on the CPU.

The plain version (what a CPU tensor takes) against JAX
`fused_leaky_relu_pallas(interpret=True)` where there is a bias (the Pallas
kernel takes one) and the XLA op `ops/fused_act.py:fused_leaky_relu`
without; the autograd gradient (x and bias) against `jax.grad` of the XLA
op.  Float32 at 1e-6 of the largest magnitude (the same operations in the
same order); bfloat16 within two bfloat16 steps of each output's magnitude:
JAX rounds ``x + bias`` and each product to bfloat16, the port once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conditional_score_diffusion_tpu.ops.fused_act import fused_leaky_relu as jax_fused_leaky_relu
from conditional_score_diffusion_tpu.ops.pallas_kernels import fused_leaky_relu_pallas
from conditional_score_diffusion_tpu_torch.ops import fused_act, fused_leaky_relu

torch.set_num_threads(1)

SHAPES = [(2, 8, 8, 16), (3, 5, 7, 6), (4, 33)]
ACTS = [(0.2, 2**0.5), (0.1, 1.0)]


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    x.flat[::7] = 0.0  # the h = 0 edge where the bias is 0 too
    b = rng.randn(shape[-1]).astype(np.float32)
    return x, b


def _jax(x, b, slope, scale, dtype):
    xj = jnp.asarray(x).astype(dtype)
    if b is None:
        return np.asarray(jax_fused_leaky_relu(xj, None, slope, scale).astype(jnp.float32))
    bj = jnp.asarray(b).astype(dtype)
    return np.asarray(fused_leaky_relu_pallas(xj, bj, slope, scale, interpret=True).astype(jnp.float32))


@pytest.mark.parametrize("slope,scale", ACTS)
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_float32(shape, with_bias, slope, scale):
    x, b = _inputs(shape, seed=len(shape))
    b = b if with_bias else None
    want = _jax(x, b, slope, scale, jnp.float32)
    got = fused_leaky_relu(torch.from_numpy(x), None if b is None else torch.from_numpy(b), slope, scale)
    assert got.dtype == torch.float32 and got.shape == shape
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("slope,scale", ACTS)
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_bf16_within_two_steps(shape, with_bias, slope, scale):
    x, b = _inputs(shape, seed=10 + len(shape))
    b = b if with_bias else None
    want = _jax(x, b, slope, scale, jnp.bfloat16)
    xt = torch.from_numpy(x).bfloat16()
    got = fused_leaky_relu(xt, None if b is None else torch.from_numpy(b).bfloat16(), slope, scale)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    # one bfloat16 step at each element's magnitude: 2^(exponent - 7)
    mag = np.maximum(np.abs(got), np.abs(want))
    step = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= 2 * step)


@pytest.mark.parametrize("slope,scale", ACTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_gradient_matches_jax_grad(shape, slope, scale):
    x, b = _inputs(shape, seed=20 + len(shape))
    g = np.random.RandomState(3).randn(*shape).astype(np.float32)

    def loss(xj, bj):
        return jnp.sum(jax_fused_leaky_relu(xj, bj, slope, scale) * jnp.asarray(g))

    dx_want, db_want = (np.asarray(v) for v in jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(b)))
    xt = torch.from_numpy(x).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    (fused_leaky_relu(xt, bt, slope, scale) * torch.from_numpy(g)).sum().backward()
    assert np.abs(xt.grad.numpy() - dx_want).max() <= 1e-6 * np.abs(dx_want).max()
    assert np.abs(bt.grad.numpy() - db_want).max() <= 1e-6 * np.abs(db_want).max()


def test_gradient_without_bias_and_at_negative_zero():
    """No bias: dx only.  A negative input whose product with the slope
    underflows to -0.0 still takes the slope; with slope 0 (a plain ReLU)
    every negative input gets no gradient."""
    x = torch.tensor([[-1e-45, -2.0, 0.0, 3.0]], requires_grad=True)
    fused_leaky_relu(x, None, 0.2, 2.0).sum().backward()
    assert torch.equal(x.grad, torch.tensor([[0.4, 0.4, 2.0, 2.0]]))
    x.grad = None
    fused_leaky_relu(x, None, 0.0, 1.0).sum().backward()
    assert x.grad.tolist() == [[0.0, 0.0, 1.0, 1.0]]


def test_checks_and_counter():
    """The wrapper refuses what the kernel does not take on either device;
    a CPU tensor runs the plain version and launches nothing."""
    x = torch.randn(2, 3, 4)
    before = fused_act.fused_leaky_relu_kernel.launches
    assert torch.equal(fused_act.fused_leaky_relu_kernel(x), fused_act.fused_leaky_relu_plain(x))
    assert fused_act.fused_leaky_relu_kernel.launches == before
    with pytest.raises(ValueError, match="shape"):
        fused_leaky_relu(x, torch.zeros(3))
    with pytest.raises(TypeError, match="bias"):
        fused_leaky_relu(x, torch.zeros(4, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_leaky_relu(x.double())
    with pytest.raises(ValueError, match="scale must be positive"):
        fused_leaky_relu(x, scale=-1.0)
    with pytest.raises(ValueError, match="negative_slope"):
        fused_leaky_relu(x, negative_slope=-0.1)
