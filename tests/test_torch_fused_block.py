"""The port's whole-resblock functions (the plain versions a CPU tensor takes)
against the JAX Pallas kernels `resblock_fused_lowres` and
`resblock_fused_lowres_split` in interpret mode, on the same numpy inputs.

Tolerances: float32 2e-5 (absolute and relative), the bound the JAX package
holds its fused kernels to against the unfused path (`models/layers.py:191-195`).
bfloat16 1e-2 of the output's largest magnitude: both sides round the same
activations and the output to bfloat16 and sum in float32 in another order,
so they differ by at most about one bfloat16 step (2**-8 = 3.9e-3 relative)
where a float32 sum lands on the other side of a rounding boundary.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conditional_score_diffusion_tpu.ops import fused_block_pallas as jax_fused
from conditional_score_diffusion_tpu_torch.ops import fused_block

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
BF16_REL_TOL = 1e-2


def _inputs(cin, cout, h, mix, with_temb, seed, batch=2):
    """Numpy inputs in the JAX layouts (HWIO convs, (Cin, Cout) shortcut)."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    x = f(batch, h, h, cin) * 1.5 + 0.3
    p = dict(
        gamma0=1.0 + 0.1 * f(cin), beta0=0.1 * f(cin),
        w0=f(3, 3, cin, cout) / np.sqrt(9 * cin), b0=0.1 * f(cout),
        temb_proj=f(batch, cout) if with_temb else None,
        gamma1=1.0 + 0.1 * f(cout), beta1=0.1 * f(cout),
        w1=f(3, 3, cout, cout) / np.sqrt(9 * cout), b1=0.1 * f(cout),
        shortcut_w=f(cin, cout) / np.sqrt(cin) if mix else None,
        shortcut_b=0.1 * f(cout) if mix else None,
    )
    return x, p


def _jax_args(p, dtype):
    conv = lambda k, v: jnp.asarray(v, dtype) if k in ("w0", "w1", "shortcut_w") else jnp.asarray(v)  # noqa: E731
    return {k: None if v is None else conv(k, v) for k, v in p.items()}


def _torch_args(p, dtype):
    out = {}
    for k, v in p.items():
        if v is None:
            out[k] = None
        elif k in ("w0", "w1"):
            out[k] = torch.from_numpy(np.ascontiguousarray(v.transpose(3, 2, 0, 1))).to(dtype)
        elif k == "shortcut_w":
            out[k] = torch.from_numpy(v).to(dtype)
        else:
            out[k] = torch.from_numpy(v)
    return out


def _run_both(x, skip, p, groups, skip_rescale, dtype):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    g0, g1 = groups
    kw = dict(num_groups0=g0, num_groups1=g1, skip_rescale=skip_rescale)
    jx = jnp.asarray(x, jdt)
    tx = torch.from_numpy(x).to(dtype)
    launches = (fused_block.resblock_fused.launches, fused_block.resblock_fused_split.launches)
    if skip is None:
        want = jax_fused.resblock_fused_lowres(jx, **_jax_args(p, jdt), **kw, interpret=True)
        got = fused_block.resblock_fused(tx, **_torch_args(p, dtype), **kw)
    else:
        want = jax_fused.resblock_fused_lowres_split(
            jx, jnp.asarray(skip, jdt), **_jax_args(p, jdt), **kw, interpret=True
        )
        got = fused_block.resblock_fused_split(
            tx, torch.from_numpy(skip).to(dtype), **_torch_args(p, dtype), **kw
        )
    # CPU: the plain version, no kernel launch
    assert (fused_block.resblock_fused.launches, fused_block.resblock_fused_split.launches) == launches
    assert got.dtype == dtype and tuple(got.shape) == tuple(want.shape)
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


# (Cin, Cout, G0, G1, H, mix shortcut, temb, skip_rescale)
BLOCK_CASES = [
    (32, 32, 8, 8, 5, False, True, False),   # identity, temb
    (24, 40, 4, 8, 6, True, False, False),   # mix shortcut, no temb
    (32, 32, 8, 8, 4, False, False, True),   # identity, rescale
    (16, 48, 4, 8, 5, True, True, True),     # mix, temb, rescale
]


@pytest.mark.parametrize("cin,cout,g0,g1,h,mix,with_temb,skip_rescale", BLOCK_CASES)
def test_block_plain_matches_jax(cin, cout, g0, g1, h, mix, with_temb, skip_rescale):
    x, p = _inputs(cin, cout, h, mix, with_temb, seed=cin + cout + h)
    got, want = _run_both(x, None, p, (g0, g1), skip_rescale, torch.float32)
    np.testing.assert_allclose(got, want, **TOL)


# (Ca, Cb, Cout, G0, G1, H, mix shortcut, temb, skip_rescale)
SPLIT_CASES = [
    (24, 16, 32, 8, 8, 5, True, True, False),   # 5-channel groups: group 4 straddles 24
    (16, 16, 32, 8, 8, 4, False, False, True),  # identity residual over the concat
    (24, 24, 16, 4, 4, 6, True, False, True),   # mix, no temb, rescale
]


@pytest.mark.parametrize("ca,cb,cout,g0,g1,h,mix,with_temb,skip_rescale", SPLIT_CASES)
def test_split_plain_matches_jax(ca, cb, cout, g0, g1, h, mix, with_temb, skip_rescale):
    x, p = _inputs(ca + cb, cout, h, mix, with_temb, seed=ca + cb + h)
    skip = np.random.RandomState(ca * cb).randn(*x.shape[:3], cb).astype(np.float32) - 0.5
    got, want = _run_both(np.ascontiguousarray(x[..., :ca]), skip, p, (g0, g1), skip_rescale, torch.float32)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("split", [False, True])
def test_bf16_plain_matches_jax(split):
    """bfloat16 inputs and weights, the vectors float32, as the bf16 model
    hands them over; the split case has a straddling group."""
    if split:
        x, p = _inputs(40, 32, 5, True, True, seed=3)
        skip = np.random.RandomState(4).randn(2, 5, 5, 16).astype(np.float32)
        got, want = _run_both(np.ascontiguousarray(x[..., :24]), skip, p, (8, 8), False, torch.bfloat16)
    else:
        x, p = _inputs(24, 40, 6, True, True, seed=5)
        got, want = _run_both(x, None, p, (4, 8), True, torch.bfloat16)
    err = np.abs(got - want).max()
    assert err <= BF16_REL_TOL * np.abs(want).max(), (err, np.abs(want).max())


def test_h_stays_float32_between_the_convs():
    """Rounding h to bfloat16 between conv0 and GN1 (two tail calls) is
    another function: the plain version must not do it.  Here h has a large
    mean and a small spread, so a bfloat16 h loses most of what GN1 keeps."""
    x, p = _inputs(16, 16, 5, False, True, seed=9)
    p["b0"] = p["b0"] + 40.0  # h ~ 40 +- 1: bfloat16 steps of 0.25 there
    got, want = _run_both(x, None, p, (4, 4), False, torch.bfloat16)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= BF16_REL_TOL * scale

    tp = _torch_args(p, torch.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    gamma, beta = tp["gamma0"], tp["beta0"]
    h = fused_block._act_conv(tx.float(), gamma, beta, 4, tp["w0"]) + (tp["b0"] + tp["temb_proj"])[:, None, None]
    h_rounded = h.to(torch.bfloat16).float()
    h1 = fused_block._act_conv(h_rounded, tp["gamma1"], tp["beta1"], 4, tp["w1"]) + tp["b1"]
    rounded = (tx.float() + h1).to(torch.bfloat16).float().numpy()
    assert np.abs(rounded - want).max() > 2 * BF16_REL_TOL * scale


def test_wrappers_refuse_bad_arguments():
    x, p = _inputs(24, 40, 5, True, False, seed=1)
    tp = _torch_args(p, torch.float32)
    kw = dict(num_groups0=4, num_groups1=8)
    tx = torch.from_numpy(x)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_block.resblock_fused(tx.to("meta"), **tp, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fused_block.resblock_fused(tx.transpose(1, 2), **tp, **kw)
    with pytest.raises(TypeError):
        fused_block.resblock_fused(tx, **dict(tp, w0=tp["w0"].to(torch.bfloat16)), **kw)
    with pytest.raises(TypeError):
        fused_block.resblock_fused(tx, **dict(tp, gamma1=tp["gamma1"].to(torch.bfloat16)), **kw)
    with pytest.raises(ValueError, match="identity residual"):
        fused_block.resblock_fused(tx, **dict(tp, shortcut_w=None, shortcut_b=None), **kw)
    with pytest.raises(ValueError, match="groups"):
        fused_block.resblock_fused(tx, **tp, num_groups0=5, num_groups1=8)
    with pytest.raises(ValueError, match="skip"):
        fused_block.resblock_fused_split(tx[..., :16].contiguous(), tx[:1, ..., 16:].contiguous(), **tp, **kw)
