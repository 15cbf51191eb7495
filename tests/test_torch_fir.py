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


def test_a_gradient_takes_the_plain_versions(monkeypatch):
    """Where a gradient must flow (grad mode on, ``x`` requiring grad),
    `upsample_2d` / `downsample_2d` take their plain versions, not the
    kernels' wrappers, and the gradient is `jax.vjp`'s of the JAX functions;
    under `no_grad`, or for an input that needs no gradient, the wrappers
    take the call."""
    seen = []
    for name in ("fir_upsample2", "fir_downsample2"):
        real = getattr(fir, name)
        monkeypatch.setattr(fir, name, lambda x, k, real=real, name=name: seen.append(name) or real(x, k))
    x = _inputs((2, 8, 10, 6), seed=6)
    g_up, g_down = _inputs((2, 16, 20, 6), seed=7), _inputs((2, 4, 5, 6), seed=8)
    xt = torch.from_numpy(x).requires_grad_()
    up, down = upfirdn.upsample_2d(xt, ASYMMETRIC, 2), upfirdn.downsample_2d(xt, ASYMMETRIC, 2)
    assert seen == []
    ((up * torch.from_numpy(g_up)).sum() + (down * torch.from_numpy(g_down)).sum()).backward()
    _, vjp_up = jax.vjp(lambda a: jax_upfirdn.upsample_2d(a, list(ASYMMETRIC), factor=2), jnp.asarray(x))
    _, vjp_down = jax.vjp(lambda a: jax_upfirdn.downsample_2d(a, list(ASYMMETRIC), factor=2), jnp.asarray(x))
    _assert_close(xt.grad, vjp_up(jnp.asarray(g_up))[0] + vjp_down(jnp.asarray(g_down))[0])
    with torch.no_grad():
        upfirdn.upsample_2d(xt, ASYMMETRIC, 2)
    upfirdn.downsample_2d(xt.detach(), ASYMMETRIC, 2)
    assert seen == ["fir_upsample2", "fir_downsample2"]


# The plans at the 20 calls of one NCSN++ forward (B=8, aligned addresses):
# (kernel, H, C) -> (vec, run, blocks) in float32 and in bfloat16, 128
# threads a block.  Vectors are 16 bytes where a pixel is whole 16-byte
# vectors (C >= 64), else 8 (float32 C=6, 24 bytes) or 4 (bfloat16 C=6, 12
# bytes); the run is 2 where a pixel is whole 32-byte sectors and the run of
# 2 leaves 98,304 threads or more (e.g. the 8x80x80x64 upsample: 8 x 80 rows
# x 40 runs x 16 vectors = 409,600), else 1.
PLANS = {
    ("fir_downsample2", 160, 64): ((4, 2, 3200), (8, 2, 1600)),
    ("fir_downsample2", 80, 64): ((4, 2, 800), (8, 1, 800)),  # bf16 at run 2: 51,200 threads
    ("fir_downsample2", 40, 128): ((4, 1, 800), (8, 1, 400)),
    ("fir_downsample2", 20, 128): ((4, 1, 200), (8, 1, 100)),
    ("fir_downsample2", 10, 256): ((4, 1, 100), (8, 1, 50)),
    ("fir_downsample2", 160, 6): ((2, 1, 1200), (2, 1, 1200)),  # 8 x 80 x 80 x 3 = 153,600 threads
    ("fir_downsample2", 80, 6): ((2, 1, 300), (2, 1, 300)),
    ("fir_downsample2", 40, 6): ((2, 1, 75), (2, 1, 75)),
    ("fir_downsample2", 20, 6): ((2, 1, 19), (2, 1, 19)),
    ("fir_downsample2", 10, 6): ((2, 1, 5), (2, 1, 5)),
    ("fir_upsample2", 5, 256): ((4, 1, 100), (8, 1, 50)),
    ("fir_upsample2", 10, 256): ((4, 1, 400), (8, 1, 200)),
    ("fir_upsample2", 20, 128): ((4, 1, 800), (8, 1, 400)),
    ("fir_upsample2", 40, 128): ((4, 2, 1600), (8, 2, 800)),
    ("fir_upsample2", 80, 64): ((4, 2, 3200), (8, 2, 1600)),
    ("fir_upsample2", 5, 6): ((2, 1, 5), (2, 1, 5)),
    ("fir_upsample2", 10, 6): ((2, 1, 19), (2, 1, 19)),
    ("fir_upsample2", 20, 6): ((2, 1, 75), (2, 1, 75)),
    ("fir_upsample2", 40, 6): ((2, 1, 300), (2, 1, 300)),
    ("fir_upsample2", 80, 6): ((2, 1, 1200), (2, 1, 1200)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,h,c", sorted(PLANS))
def test_launch_plan_at_the_ncsnpp_calls(name, h, c, dtype):
    import chip_smoke

    assert {(n, hh, cc) for n, hh, cc, _ in chip_smoke.FIR_SHAPES} == set(PLANS)
    vec, run, blocks = PLANS[(name, h, c)][dtype == torch.bfloat16]
    assert fir.launch_plan(8, h, h, c, dtype, (0, 512), down=name == "fir_downsample2") == (vec, run, 128, blocks)


@pytest.mark.parametrize(
    "args,want",
    [
        # odd H and W and 3 or 6 channels (the upsample): not whole vectors of 16 bytes, nor sectors
        ((3, 5, 7, 3, torch.float32, (0, 0)), (1, 1, 128, 3)),  # 12 bytes a pixel: 4-byte vectors
        ((3, 5, 7, 3, torch.bfloat16, (0, 0)), (1, 1, 128, 3)),  # 6 bytes: one element, 315 threads
        ((2, 7, 9, 6, torch.float32, (0, 0)), (2, 1, 128, 3)),  # 2 x 7 x 9 x 3 = 378 threads
        ((8, 15, 13, 64, torch.float32, (0, 0)), (4, 1, 128, 195)),  # 24,960 threads; 13,440 at run 2
        ((8, 15, 13, 64, torch.bfloat16, (0, 0)), (8, 1, 128, 98)),
        # an input 4 bytes past an aligned address: 4-byte vectors, so 4x (2x) the threads
        ((8, 40, 40, 128, torch.float32, (4, 0)), (1, 2, 128, 6400)),
        ((8, 40, 40, 128, torch.bfloat16, (4, 0)), (2, 2, 128, 3200)),
        ((8, 20, 20, 6, torch.float32, (4, 0)), (1, 1, 128, 150)),
        # 2 bytes off (bfloat16): one element; an output 8 bytes off: 8-byte vectors
        ((8, 40, 40, 128, torch.bfloat16, (2, 0)), (1, 2, 128, 6400)),
        ((8, 40, 40, 128, torch.float32, (0, 8)), (2, 2, 128, 3200)),
    ],
)
def test_launch_plan_narrows_the_vector(args, want):
    assert fir.launch_plan(*args) == want


def test_launch_plan_refuses_calls_past_32_bit_offsets():
    fir.launch_plan(1, 4096, 4096, 32, torch.float32, (0, 0), down=True)  # 2^29 elements an image
    with pytest.raises(ValueError, match="32-bit"):
        fir.launch_plan(1, 4096, 4096, 32, torch.float32, (0, 0))  # its output: 2^31


def _walk(x, k, down, run):
    """The kernels' arithmetic in plain PyTorch, walked the way a thread
    walks W: every (image, row, vector) at once, each run of ``run`` pixels
    keeping the vertical sums of the overlapping input columns (up: of
    output rows 2t and 2t+1; down: of the 4 input rows) and taking one new
    column (up) or two (down) a step; float32, rounded once."""
    xf = x.float()
    B, H, W, C = xf.shape
    c0, c1, c2, c3 = (float(v) for v in fir.norm_taps(k, 1.0 if down else 2.0))
    if down:
        Ho, Wo = H // 2, W // 2
        pad = torch.nn.functional.pad(xf, (0, 0, 0, 0, 1, 1))  # row r at r + 1
        rows = [pad[:, a : a + 2 * Ho : 2] for a in range(4)]  # input rows 2oy - 1 + a

        def column(j):
            if not 0 <= j < W:
                return torch.zeros(B, Ho, C)
            return c3 * rows[0][:, :, j] + c2 * rows[1][:, :, j] + c1 * rows[2][:, :, j] + c0 * rows[3][:, :, j]

        out = torch.empty(B, Ho, Wo, C)
        for ox0 in range(0, Wo, run):
            va, vb = column(2 * ox0 - 1), column(2 * ox0)
            for ox in range(ox0, min(ox0 + run, Wo)):
                vc, vd = column(2 * ox + 1), column(2 * ox + 2)
                out[:, :, ox] = c3 * va + c2 * vb + c1 * vc + c0 * vd
                va, vb = vc, vd
        return out.to(x.dtype)
    above = torch.nn.functional.pad(xf, (0, 0, 0, 0, 1, 0))[:, :H]  # row t - 1
    below = torch.nn.functional.pad(xf, (0, 0, 0, 0, 0, 1))[:, 1:]  # row t + 1

    def column(j):  # the vertical sums of output rows 2t and 2t + 1 at input column j
        if not 0 <= j < W:
            return torch.zeros(B, H, C), torch.zeros(B, H, C)
        return c3 * above[:, :, j] + c1 * xf[:, :, j], c2 * xf[:, :, j] + c0 * below[:, :, j]

    out = torch.empty(B, 2 * H, 2 * W, C)
    for tx0 in range(0, W, run):
        (ep, op), (ec, oc) = column(tx0 - 1), column(tx0)
        for tx in range(tx0, min(tx0 + run, W)):
            en, on = column(tx + 1)
            out[:, 0::2, 2 * tx] = c3 * ep + c1 * ec
            out[:, 0::2, 2 * tx + 1] = c2 * ec + c0 * en
            out[:, 1::2, 2 * tx] = c3 * op + c1 * oc
            out[:, 1::2, 2 * tx + 1] = c2 * oc + c0 * on
            (ep, op), (ec, oc) = (ec, oc), (en, on)
    return out.to(x.dtype)


@pytest.mark.parametrize("k", [fir.FIR_KERNEL, ASYMMETRIC])
@pytest.mark.parametrize("run", [1, fir.RUN])
@pytest.mark.parametrize("kind,shape", [("up", (2, 7, 9, 6)), ("up", (1, 6, 10, 3)), ("down", (2, 8, 10, 4))])
def test_the_kernels_walk_matches_plain(kind, shape, run, k):
    """The per-thread walk along W (`_walk`; runs that end past W
    included) against the plain versions at 1e-6 of the largest magnitude."""
    x = torch.from_numpy(_inputs(shape, seed=9))
    plain = fir.fir_downsample2_plain if kind == "down" else fir.fir_upsample2_plain
    want = plain(x, k)
    got = _walk(x, k, kind == "down", run)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * want.abs().max().item())
