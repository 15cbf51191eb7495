"""The port of TPU kernels 4 and 5 (`ops/conv3x3.py`) against the JAX
package's `ops/conv_pallas.py`, and the conv policy in the toy `ddpm_paired`.

On the CPU the wrappers take the plain version (`F.conv2d` on the NCHW
view), and `Conv3x3Function` computes the input gradient as a 3x3 conv of
the output gradient with the weights rotated by 180 degrees and Cin/Cout
swapped, the weight gradient with `torch.nn.grad.conv2d_weight`: the same
arithmetic the kernel path does on the card.  JAX runs its Pallas kernels in
interpret mode (`tests/test_pallas_kernels.py`'s way) and its `custom_vjp`
backward through XLA.  Weights are random and not symmetric, and Cin != Cout,
so a flipped axis or an unswapped Cin/Cout in the rotation fails.

Tolerances: float32 2e-5 of the largest magnitude (sums in another order);
bfloat16 one bfloat16 step of each element (2**-7 of its magnitude): both
sum the products in float32 and round once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_splitk import check_plan, split_k_conv
from _torch_port_toy import hold_gradients, jax_toy_params, toy_inputs, train_toy_configs
from conditional_score_diffusion_tpu.ops import conv_pallas
from conditional_score_diffusion_tpu_torch.models import create_model, layers
from conditional_score_diffusion_tpu_torch.models.convert import flax_to_state_dict
from conditional_score_diffusion_tpu_torch.ops import conv3x3 as ops

torch.set_num_threads(1)

F32_TOL = 2e-5
BF16_STEP = 2.0**-7
# (B, H, W, Cin, Cout): the network's 6-channel input conv, a 32-channel conv,
# the halves of an uneven split (24 + 16 -> 32) and a 6-channel output conv.
SHAPES = [(2, 8, 8, 6, 32), (2, 8, 8, 32, 32), (2, 8, 6, 24, 32), (2, 8, 6, 16, 32), (2, 7, 9, 32, 6)]


def _inputs(B, H, W, Cin, Cout, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, W, Cin).astype(np.float32)
    w = (rng.randn(3, 3, Cin, Cout) / np.sqrt(9 * Cin)).astype(np.float32)  # HWIO, not symmetric
    g = rng.randn(B, H, W, Cout).astype(np.float32)
    return x, w, g


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))


def _close(got, want, tol=F32_TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_forward_matches_jax(shape):
    x, w, _ = _inputs(*shape)
    want_pallas = conv_pallas.conv3x3_pallas(jnp.asarray(x), jnp.asarray(w), True)
    want_xla = conv_pallas._xla_conv(jnp.asarray(x), jnp.asarray(w))
    got = ops.conv3x3_plain(torch.from_numpy(x), _oihw(w))
    _close(got.numpy(), want_pallas)
    _close(got.numpy(), want_xla)
    assert torch.equal(ops.conv3x3(torch.from_numpy(x), _oihw(w)), got)  # the wrapper on a CPU tensor


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_plain_forward_bf16_within_one_step_of_jax(shape):
    x, w, _ = _inputs(*shape, seed=1)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = np.asarray(conv_pallas.conv3x3_pallas(xb, wb, True).astype(jnp.float32))
    got = ops.conv3x3(
        torch.from_numpy(np.asarray(xb.astype(jnp.float32))).bfloat16(),
        _oihw(np.asarray(wb.astype(jnp.float32))).bfloat16(),
    )
    assert got.dtype == torch.bfloat16
    assert (np.abs(got.float().numpy() - want) <= BF16_STEP * np.abs(want)).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_vjp_matches_jax(shape):
    """`Conv3x3Function` (plain forward, rotated-weight conv for dx,
    `conv2d_weight` for dW, the bias gradient) against `jax.vjp` of
    `conv3x3_pallas` and of XLA's conv, with a bias added after."""
    x, w, g = _inputs(*shape, seed=2)
    b = np.random.RandomState(3).randn(shape[-1]).astype(np.float32)

    def jax_fn(conv):
        return lambda x, w, b: conv(x, w) + b

    for conv in (lambda x, w: conv_pallas.conv3x3_pallas(x, w, True), conv_pallas._xla_conv):
        _, vjp = jax.vjp(jax_fn(conv), jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
        dx, dw, db = vjp(jnp.asarray(g))
        xt = torch.from_numpy(x).requires_grad_()
        wt = _oihw(w).requires_grad_()
        bt = torch.from_numpy(b).requires_grad_()
        ops.conv3x3(xt, wt, bt).backward(torch.from_numpy(g))
        _close(xt.grad.numpy(), dx)
        _close(wt.grad.numpy(), np.transpose(np.asarray(dw), (3, 2, 0, 1)))
        _close(bt.grad.numpy(), db)


def test_no_input_gradient_where_none_is_needed(monkeypatch):
    """``ctx.needs_input_grad``: with x constant the backward makes the
    weight gradient and no dx conv."""
    calls = []
    real = ops._conv3x3_nhwc
    monkeypatch.setattr(ops, "_conv3x3_nhwc", lambda *a: calls.append(a[0].shape) or real(*a))
    x, w, g = _inputs(*SHAPES[0])
    wt = _oihw(w).requires_grad_()
    ops.conv3x3(torch.from_numpy(x), wt).backward(torch.from_numpy(g))
    assert calls == [torch.Size(x.shape)] and wt.grad is not None
    calls.clear()
    ops.conv3x3(torch.from_numpy(x).requires_grad_(), wt).backward(torch.from_numpy(g))
    assert calls == [torch.Size(x.shape), torch.Size(g.shape)]


@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[4]])
def test_hmajor_matches_jax(shape):
    """The (H, W, B, C) entry against JAX `conv3x3_hmajor` in interpret mode,
    and against the NHWC entry on the transposed tensor."""
    x, w, _ = _inputs(*shape, seed=4)
    xt = np.ascontiguousarray(np.transpose(x, (1, 2, 0, 3)))
    want = conv_pallas.conv3x3_hmajor(jnp.asarray(xt), jnp.asarray(w), interpret=True)
    got = ops.conv3x3_hmajor(torch.from_numpy(xt), _oihw(w))
    assert tuple(got.shape) == tuple(want.shape)
    _close(got.numpy(), want)
    _close(got.numpy(), ops.conv3x3(torch.from_numpy(x), _oihw(w)).permute(1, 2, 0, 3).numpy())


def test_wrappers_refuse_what_the_kernel_does_not_take():
    x, w, _ = _inputs(*SHAPES[1])
    xt, wt = torch.from_numpy(x), _oihw(w)
    with pytest.raises(ValueError, match="contiguous"):
        ops.conv3x3(xt.transpose(1, 2), wt)
    with pytest.raises(TypeError):
        ops.conv3x3(xt, wt.double())
    with pytest.raises(ValueError, match="shape"):
        ops.conv3x3(xt, wt[:, :5])
    with pytest.raises(TypeError):
        ops.conv3x3(xt, wt, torch.zeros(32, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        ops.conv3x3_hmajor(xt.permute(1, 2, 0, 3), wt)


@pytest.fixture(scope="module")
def toy_model_params():
    jconfig, _ = train_toy_configs(dropout=0.0)
    _, params = jax_toy_params(jconfig, seed=3)
    return flax_to_state_dict(params)


def test_policy_names():
    _, tconfig = train_toy_configs()
    for name, on in layers.CONV_POLICIES.items():
        tconfig.model.conv_dispatch = name
        model = create_model(tconfig, device="cpu")
        convs = [m for m in model.modules() if isinstance(m, layers.Conv3x3)]
        assert all(m.use_kernel == (on and m.stride == 1) for m in convs), name
        assert any(m.stride == 2 for m in convs) and any(m.use_kernel for m in convs) == on
    tconfig.model.conv_dispatch = "im2col_everywhere"
    with pytest.raises(KeyError):
        create_model(tconfig, device="cpu")


def test_toy_forward_and_gradients_with_the_policy_on_and_off(toy_model_params, monkeypatch):
    """The toy `ddpm_paired` in train mode (dropout 0) with
    ``conv_dispatch='conv3x3_kernel'`` against ``'none'``: outputs and every
    parameter's gradient at 2e-5 of their largest magnitude (tensors of
    rounding noise as `hold_gradients` says), and the wrapper
    carries every stride-1 conv of the forward and every dx of the backward
    but the first conv's."""
    x, y, t = (torch.from_numpy(a) for a in toy_inputs())
    results = {}
    calls = {"n": 0}
    real = ops._conv3x3_nhwc

    def counted(*a):
        calls["n"] += 1
        return real(*a)

    monkeypatch.setattr(ops, "_conv3x3_nhwc", counted)
    for policy in ("conv3x3_kernel", "none"):
        _, tconfig = train_toy_configs(dropout=0.0)
        tconfig.model.conv_dispatch = policy
        model = create_model(tconfig, device="cpu").train()
        model.load_state_dict(toy_model_params)
        calls["n"] = 0
        out = model({"x": x, "y": y}, t * 999)
        n_forward = calls["n"]
        (out["x"].square().sum() + out["y"].sin().sum()).backward()
        results[policy] = (out, {n: p.grad for n, p in model.named_parameters()}, n_forward, calls["n"] - n_forward)
    on, off = results["conv3x3_kernel"], results["none"]
    for k in ("x", "y"):
        _close(on[0][k].detach().numpy(), off[0][k].detach().numpy())
    hold_gradients(on[1], off[1], F32_TOL)
    # conv_in, 2 per down block, 2 per mid block, 3 per (split) up block, 2 up convs, conv_out
    n_convs = 1 + 3 * 2 + 2 * 2 + 6 * 3 + 2 + 1
    assert (on[2], on[3]) == (n_convs, n_convs - 1)
    assert (off[2], off[3]) == (0, 0)


def test_flagship_train_step_launch_counts_match_chip_smoke(monkeypatch):
    """The full-width flagship with the policy on, on the meta device: the
    3x3 stride-1 convs of one forward and of the backward's dx, and of one
    eval forward (the fused tail takes the conv of the 17 gated tails there),
    as `chip_smoke.py` expects them."""
    import chip_smoke
    from conditional_score_diffusion_tpu_torch.configs import texture160_sr_cmde_conv3x3_config

    phase = {"name": "forward"}
    calls = {"forward": 0, "dx": 0, "eval": 0, "tail": 0}

    def stub(x, w, bias):
        calls[phase["name"]] += 1
        return torch.empty(*x.shape[:-1], w.shape[0], device=x.device, dtype=x.dtype)

    def tail(x, w, *args, **kwargs):
        calls["tail"] += 1
        return torch.empty(*x.shape[:-1], w.shape[0], device=x.device, dtype=x.dtype)

    monkeypatch.setattr(ops, "_conv3x3_nhwc", stub)
    monkeypatch.setattr(layers, "gn_silu_conv3x3", tail)
    config = texture160_sr_cmde_conv3x3_config()
    model = create_model(config, device="meta").train()
    x = torch.empty(16, 160, 160, 3, device="meta")
    out = model({"x": x, "y": x}, torch.empty(16, device="meta"))
    phase["name"] = "dx"
    (out["x"].sum() + out["y"].sum()).backward()
    phase["name"] = "eval"
    model.eval()
    with torch.no_grad():
        model({"x": x[:8], "y": x[:8]}, torch.empty(8, device="meta"))
    assert calls["tail"] == chip_smoke.PER_FORWARD_TAIL_PATH["gn_silu_conv3x3"]
    assert (calls["forward"], calls["dx"]) == chip_smoke.CONV_PER_TRAIN_STEP
    assert calls["eval"] == chip_smoke.CONV_PER_EVAL_FORWARD


# ---- the launch plan and its split-K partition (csrc/conv3x3_core.cuh) --------


@pytest.fixture(scope="module")
def train_step_shapes():
    """(phase, H, Cin, Cout) -> calls of one flagship train step, counted on
    the meta device as `chip_smoke.py` counts them."""
    import chip_smoke

    shapes = chip_smoke.conv_call_shapes(chip_smoke.train_configs())
    per_step = tuple(sum(n for (ph, *_), n in shapes.items() if ph == p) for p in ("forward", "dx"))
    assert per_step == chip_smoke.CONV_PER_TRAIN_STEP
    return shapes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_plan_at_every_train_step_shape(train_step_shapes, dtype):
    import chip_smoke

    for ph, h, cin, cout in train_step_shapes:
        plan = check_plan(chip_smoke.TRAIN_BATCH * h * h, cin, cout, dtype)
        if h <= 10:
            assert plan.splits > 1, (ph, h, cin, cout)  # the 5x5 and 10x10 convs fill the card by split-K
        assert plan.a_vec == (cin % (16 // torch.tensor([], dtype=dtype).element_size()) == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,Cin,Cout", [(147, 6, 6), (100, 13, 20), (3200, 192, 192), (400, 288, 288),
                                        (409600, 96, 96), (409600, 6, 96), (409600, 96, 6), (1, 1, 1)])
def test_launch_plan_at_odd_shapes(M, Cin, Cout, dtype, monkeypatch):
    check_plan(M, Cin, Cout, dtype)
    monkeypatch.setattr(ops, "MAX_SPLITS", 1)  # what the card tests do to force the unsplit plan
    assert ops.launch_plan(M, Cin, Cout, dtype).splits == 1


def test_launch_plan_copy_widths():
    plan = ops.launch_plan(1000, 6, 96, torch.float32)
    assert (plan.a_vec, plan.b_vec) == (0, 1)
    plan = ops.launch_plan(1000, 96, 6, torch.bfloat16)
    assert (plan.a_vec, plan.b_vec) == (1, 0)
    assert ops.launch_plan(1000, 96, 96, torch.float32, x_aligned=False).a_vec == 0


# (B, H, W, Cin, Cout): the input conv's Cin = 6, the output conv's Cout = 6,
# a ragged M (3 * 7 * 5 = 105 pixels), 4x4 images, a split of 8 at 5x5.
SPLIT_SHAPES = [(2, 8, 8, 6, 32), (3, 7, 5, 32, 6), (3, 7, 5, 24, 40), (4, 4, 4, 64, 64), (2, 5, 5, 96, 96)]


@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_split_k_emulation_matches_plain(shape):
    """Per-split partial convs over the plan's K ranges, summed in rank
    order, equal the plain version within 1e-6 (float32)."""
    B, H, W, Cin, Cout = shape
    x, w, _ = _inputs(*shape, seed=5)
    xt, wt = torch.from_numpy(x), _oihw(w)
    bias = torch.linspace(-0.2, 0.3, Cout)
    plan = check_plan(B * H * W, Cin, Cout, torch.float32)
    assert plan.splits > 1
    _close(split_k_conv(xt, wt, plan, bias).numpy(), ops.conv3x3_plain(xt, wt, bias).numpy(), tol=1e-6)


def test_build_digest_follows_shared_headers(tmp_path):
    """`ops.nvcc.source_digest` (the build's cache key) changes with the
    source, with any `*.cuh` beside it and with a new header, so an edit of
    `conv3x3_core.cuh` rebuilds both libraries that include it."""
    from conditional_score_diffusion_tpu_torch.ops import nvcc

    (tmp_path / "a.cu").write_text('#include "core.cuh"\n')
    (tmp_path / "b.cu").write_text('#include "core.cuh"\n// b\n')
    (tmp_path / "core.cuh").write_text("// v1\n")
    first = {n: nvcc.source_digest(n, tmp_path) for n in ("a", "b")}
    assert first == {n: nvcc.source_digest(n, tmp_path) for n in ("a", "b")} and first["a"] != first["b"]
    (tmp_path / "core.cuh").write_text("// v2\n")
    second = {n: nvcc.source_digest(n, tmp_path) for n in ("a", "b")}
    assert all(second[n] != first[n] for n in first)
    (tmp_path / "extra.cuh").write_text("// new\n")
    assert all(nvcc.source_digest(n, tmp_path) != second[n] for n in first)
    assert nvcc.source_digest("conv3x3") != nvcc.source_digest("gn_silu_conv3x3")
