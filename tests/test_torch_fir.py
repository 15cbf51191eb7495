"""The port's FIR resampling (`ops/upfirdn.py`, `ops/fir.py`) against the
JAX package's, on the CPU.

On a CPU tensor `fir_upsample2` / `fir_downsample2` take their plain
versions (`upsample_2d` / `downsample_2d` of `ops/upfirdn.py` at factor 2),
which are held here against the JAX Pallas kernels in interpret mode and
against JAX's `ops.upfirdn`, on the same numpy inputs.  Tolerances: float32
1e-5 of the largest magnitude.  Bfloat16: the port sums in float32 and
rounds once, so it is within one bfloat16 step at the largest magnitude
(2^-7 of it) of the float32 result on the same bfloat16 inputs; the JAX
functions round after each separable pass, so the port is within two steps
of them.
"""

import jax  # noqa: F401  (the parity files import both frameworks)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conditional_score_diffusion_tpu.ops import upfirdn as jax_upfirdn
from conditional_score_diffusion_tpu.ops.pallas_kernels import fir_downsample2 as jax_fir_down
from conditional_score_diffusion_tpu.ops.pallas_kernels import fir_upsample2 as jax_fir_up
from conditional_score_diffusion_tpu_torch.ops import fir, upfirdn

torch.set_num_threads(1)

ASYMMETRIC = (1.0, 2.0, 5.0, 0.5)


def _inputs(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32) * 1.5 + 0.3


def _assert_close(got, want, tol=1e-5):
    """Within ``tol`` of the largest magnitude of ``want``."""
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [6, 32])
@pytest.mark.parametrize("kind", ["up", "down"])
def test_fir_matches_jax_pallas_and_upfirdn(kind, c, dtype):
    x = _inputs((2, 10, 8, c))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xj = jnp.asarray(x).astype(jdt)
    xt = torch.from_numpy(x).to(dtype)
    port = fir.fir_upsample2 if kind == "up" else fir.fir_downsample2
    pallas = jax_fir_up if kind == "up" else jax_fir_down
    xla = jax_upfirdn.upsample_2d if kind == "up" else jax_upfirdn.downsample_2d
    launches = port.launches
    got = port(xt)
    assert got.dtype == dtype and port.launches == launches  # no kernel on the CPU
    if dtype == torch.float32:
        _assert_close(got, pallas(xj, interpret=True))
        _assert_close(got, xla(xj, [1, 3, 3, 1], factor=2))
    else:
        step = 2.0**-7  # one bfloat16 step at the largest magnitude
        _assert_close(got, xla(xj.astype(jnp.float32), [1, 3, 3, 1], factor=2), step)
        _assert_close(got, pallas(xj, interpret=True), 2 * step)
        _assert_close(got, xla(xj, [1, 3, 3, 1], factor=2), 2 * step)


@pytest.mark.parametrize("kind", ["up", "down"])
def test_non_symmetric_kernel_matches_jax(kind):
    x = _inputs((2, 8, 12, 6), seed=1)
    port = fir.fir_upsample2 if kind == "up" else fir.fir_downsample2
    pallas = jax_fir_up if kind == "up" else jax_fir_down
    xla = jax_upfirdn.upsample_2d if kind == "up" else jax_upfirdn.downsample_2d
    got = port(torch.from_numpy(x), ASYMMETRIC)
    _assert_close(got, pallas(jnp.asarray(x), k=ASYMMETRIC, interpret=True))
    _assert_close(got, xla(jnp.asarray(x), list(ASYMMETRIC), factor=2))


@pytest.mark.parametrize(
    "kind,k,factor,gain",
    [("up", [1, 3, 3, 1], 4, 1.0), ("down", [1, 3, 3, 1], 4, 1.0), ("up", [1, 1], 2, 1.0),
     ("down", None, 3, 1.0), ("up", [1, 3, 3, 1], 2, 2.0)],
)
def test_other_resampling_matches_jax(kind, k, factor, gain):
    """Factors, kernels and gains the factor-2 kernels do not take stay in
    `ops/upfirdn.py`."""
    x = _inputs((2, 12, 12, 5), seed=2)
    port = upfirdn.upsample_2d if kind == "up" else upfirdn.downsample_2d
    xla = jax_upfirdn.upsample_2d if kind == "up" else jax_upfirdn.downsample_2d
    _assert_close(port(torch.from_numpy(x), k, factor, gain), xla(jnp.asarray(x), k, factor, gain))


@pytest.mark.parametrize("kind", ["up", "down"])
def test_fused_conv_resampling_matches_jax(kind):
    """`upsample_conv_2d` / `conv_downsample_2d` with an HWIO weight in JAX
    and the same weight OIHW in the port."""
    rng = np.random.RandomState(3)
    x = _inputs((2, 8, 8, 6), seed=3)
    w = (rng.randn(3, 3, 6, 5) / np.sqrt(54)).astype(np.float32)
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    if kind == "up":
        got = upfirdn.upsample_conv_2d(torch.from_numpy(x), wt, k=[1, 3, 3, 1])
        want = jax_upfirdn.upsample_conv_2d(jnp.asarray(x), jnp.asarray(w), k=[1, 3, 3, 1])
    else:
        got = upfirdn.conv_downsample_2d(torch.from_numpy(x), wt, k=[1, 3, 3, 1])
        want = jax_upfirdn.conv_downsample_2d(jnp.asarray(x), jnp.asarray(w), k=[1, 3, 3, 1])
    _assert_close(got, want)


def test_upfirdn2d_and_naive_resampling_match_jax():
    x = _inputs((2, 9, 7, 4), seed=4)
    kernel = jax_upfirdn.setup_kernel([1, 2, 1], 2.0)
    np.testing.assert_array_equal(upfirdn.setup_kernel([1, 2, 1], 2.0), kernel)
    for up, down, pad in ((2, 1, (1, 1)), (1, 2, (0, -1)), (3, 2, (2, 0))):
        _assert_close(
            upfirdn.upfirdn2d(torch.from_numpy(x), kernel, up, down, pad),
            jax_upfirdn.upfirdn2d(jnp.asarray(x), kernel, up, down, pad),
        )
    x = _inputs((2, 8, 6, 4), seed=5)
    _assert_close(upfirdn.naive_upsample_2d(torch.from_numpy(x), 2), jax_upfirdn.naive_upsample_2d(jnp.asarray(x), 2))
    _assert_close(
        upfirdn.naive_downsample_2d(torch.from_numpy(x), 2), jax_upfirdn.naive_downsample_2d(jnp.asarray(x), 2)
    )


def test_factor2_resampling_goes_through_the_kernel_wrappers(monkeypatch):
    """`upsample_2d` / `downsample_2d` at factor 2, 4 taps and gain 1 call
    `fir_upsample2` / `fir_downsample2` (on the CPU: their plain versions);
    the wrappers refuse what the kernels do not take, on the CPU too."""
    seen = []
    for name in ("fir_upsample2", "fir_downsample2"):
        real = getattr(fir, name)
        monkeypatch.setattr(fir, name, lambda x, k, real=real, name=name: seen.append(name) or real(x, k))
    x = torch.from_numpy(_inputs((1, 6, 6, 3))).transpose(1, 2)  # not contiguous
    upfirdn.upsample_2d(x, (1, 3, 3, 1), 2)
    upfirdn.downsample_2d(x, [1, 3, 3, 1], 2)
    upfirdn.upsample_2d(x, (1, 3, 3, 1), 2, gain=2.0)
    upfirdn.downsample_2d(x, (1, 1), 2)
    assert seen == ["fir_upsample2", "fir_downsample2"]
    monkeypatch.undo()
    with pytest.raises(ValueError, match="even"):
        fir.fir_downsample2(torch.zeros(1, 5, 6, 3))
    with pytest.raises(ValueError, match="contiguous"):
        fir.fir_upsample2(x)
    with pytest.raises(TypeError):
        fir.fir_upsample2(torch.zeros(1, 4, 4, 3, dtype=torch.float16))
    with pytest.raises(ValueError, match="4-tap"):
        fir.fir_downsample2(torch.zeros(1, 4, 4, 3), (1, 2, 1))
    with pytest.raises(ValueError, match="NHWC"):
        fir.fir_upsample2(torch.zeros(4, 4, 3))
