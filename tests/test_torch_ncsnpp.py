"""The port's NCSN++ family against the JAX one on the same weights.

The JAX toy model's params (`init_model`, then every leaf redrawn by numpy
so no conv is zero; the Fourier projection's W keeps its N(0, 16^2) draw)
go through `models/convert.py`; both forwards run in eval mode on the same
inputs.  The cases follow the JAX package's NCSN++ tests
(`tests/test_models.py:112`, `tests/test_ncsnpp_parity.py:89`):
progressive output x progressive input x resblock type x FIR x embedding,
and the DF2K direct 4x recipe's `ncsnpp_KxSR` cut to 32px (y 8x8, scale 4)
with the Fourier embedding at labels near 999, with the fused kernels off
and on in both frameworks (JAX: Pallas in interpret mode; the port: the
plain versions a CPU tensor takes).  Tolerance 5e-4, the JAX package's bound
for a same-weights forward; the port's kernel path against its unfused path
2e-5 of the largest magnitude; the 3-step KxSR sampler, fed the JAX key
chain's noise, 1e-4 of its largest magnitude; every parameter's gradient of
a loss on the output of the FIR models against `jax.grad`, 1e-4 of each
tensor's largest magnitude (`_torch_port_toy.hold_gradients`).
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_toy import Replay, hold_gradients, jax_sampler_draws, randomize_params, reset_jax_dispatch
from conditional_score_diffusion_tpu.configs import base as jax_base
from conditional_score_diffusion_tpu.configs.srflow import df2k_config as jax_df2k_config
from conditional_score_diffusion_tpu.models import init_model
from conditional_score_diffusion_tpu.models import layers as jax_layers
from conditional_score_diffusion_tpu.ops import fused_block_pallas as jax_fused
from conditional_score_diffusion_tpu.sampling import pc as jax_pc
from conditional_score_diffusion_tpu.sde import build_sde as jax_build_sde
from conditional_score_diffusion_tpu.training.schedules import sigma_y_at_step as jax_sigma_y_at_step
from conditional_score_diffusion_tpu_torch.configs import base as torch_base
from conditional_score_diffusion_tpu_torch.configs import df2k_config
from conditional_score_diffusion_tpu_torch.models import create_model, layers
from conditional_score_diffusion_tpu_torch.models.convert import flax_to_state_dict, state_dict_to_flax
from conditional_score_diffusion_tpu_torch.ops import fir
from conditional_score_diffusion_tpu_torch.sampling import get_conditional_sampling_fn
from conditional_score_diffusion_tpu_torch.sde import build_sde
from conditional_score_diffusion_tpu_torch.training.schedules import sigma_y_at_step

torch.set_num_threads(1)

KXSR = "kxsr"
# (fir, progressive, progressive_input, resblock_type, embedding_type, combine)
CASES = [
    (False, "none", "none", "biggan", "positional", "sum"),
    (True, "output_skip", "residual", "biggan", "positional", "sum"),
    (True, "output_skip", "input_skip", "biggan", "positional", "cat"),
    (True, "none", "residual", "biggan", "fourier", "sum"),
    (False, "none", "none", "ddpm", "positional", "sum"),
    (True, "residual", "residual", "ddpm", "positional", "sum"),
]


def ncsnpp_config(base, case):
    """A 16px NCSN++ recipe in either framework (``base``: its configs.base)."""
    fir_, progressive, progressive_input, resblock_type, embedding_type, combine = case
    c = base.base_config()
    base.image_model_defaults(c.model)
    m, d = c.model, c.data
    m.name, m.nf, m.ch_mult, m.num_res_blocks, m.attn_resolutions = "ncsnpp", 16, (1, 2), 1, (8,)
    m.dropout, m.fir, m.resblock_type, m.embedding_type = 0.0, fir_, resblock_type, embedding_type
    m.progressive, m.progressive_input, m.progressive_combine = progressive, progressive_input, combine
    d.image_size = d.effective_image_size = 16
    d.num_channels, d.shape = 3, [3, 16, 16]
    return c


def kxsr_config(df2k, fused=False):
    """The DF2K direct 4x recipe cut to 32px (y 8x8)."""
    c = df2k("direct")
    c.data.image_size = c.data.effective_image_size = c.data.target_resolution = 32
    c.data.shape_x, c.data.shape_y = [3, 32, 32], [3, 8, 8]
    c.model.nf, c.model.ch_mult, c.model.num_res_blocks, c.model.attn_resolutions = 32, (1, 2, 2), 1, (16,)
    c.model.fused_tail = c.model.fused_block = fused
    return c


def configs(case, fused=False):
    if case == KXSR:
        return kxsr_config(jax_df2k_config, fused), kxsr_config(df2k_config, fused)
    return ncsnpp_config(jax_base, case), ncsnpp_config(torch_base, case)


def jax_params(config):
    try:
        module, params = init_model(config, jax.random.key(0))
    finally:
        reset_jax_dispatch()
    params = jax.device_get(params)
    out = randomize_params(params)
    tree = params.get("unet", params)
    if "fourier" in tree:  # keep W ~ N(0, 16^2): the phase x*W*2*pi reaches ~1e5 rad
        out.get("unet", out)["fourier"]["W"] = np.asarray(tree["fourier"]["W"])
    return module, out


def inputs(case):
    rng = np.random.RandomState(0)
    if case == KXSR:
        x, y = rng.rand(2, 32, 32, 3).astype(np.float32), rng.rand(2, 8, 8, 3).astype(np.float32)
        return {"x": x, "y": y}, np.array([998.7, 990.2], np.float32)
    labels = np.array([998.7, 3.0] if case[4] == "fourier" else [10.0, 500.0], np.float32)
    return rng.rand(2, 16, 16, 3).astype(np.float32), labels


def jax_forward(module, params, x, labels, fused=False):
    try:
        if fused:
            jax_layers.set_fused_gn_conv_dispatch(jax_layers.fused_tail_candidate_policy)
            jax_layers.set_fused_block_dispatch(jax_layers.fused_block_candidate_policy)
        return jax.device_get(module.apply({"params": params}, x, labels, train=False))
    finally:
        reset_jax_dispatch()


def torch_forward(model, x, labels):
    xt = {k: torch.from_numpy(v) for k, v in x.items()} if isinstance(x, dict) else torch.from_numpy(x)
    with torch.no_grad():
        out = model(xt, torch.from_numpy(labels))
    return {k: v.numpy() for k, v in out.items()} if isinstance(out, dict) else out.numpy()


def as_dict(out):
    return out if isinstance(out, dict) else {"out": out}


@pytest.mark.parametrize(
    "case,fused",
    [(case, False) for case in CASES] + [(KXSR, False), (KXSR, True)],
    ids=["-".join(map(str, c)) for c in CASES] + ["kxsr", "kxsr-fused"],
)
def test_forward_matches_jax(case, fused):
    jconfig, tconfig = configs(case, fused)
    module, params = jax_params(jconfig)
    x, labels = inputs(case)
    want = jax_forward(module, params, x, labels, fused)
    model = create_model(tconfig, device="cpu")
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    got = torch_forward(model, x, labels)
    for k, w in as_dict(want).items():
        g = as_dict(got)[k]
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=5e-4, atol=5e-4)


def test_paired_variants_match_jax():
    """`ncsnpp_paired`, `ncsnpp_paired_SR3` and `ncsnpp_2xSR` around one
    NCSN++, same weights, at 5e-4 (2xSR: x 16px squeezed to 8px beside y
    at 8px, so the network's ``effective_image_size`` is 8)."""
    rng = np.random.RandomState(1)
    x = rng.rand(2, 16, 16, 3).astype(np.float32)
    for name, y_size, channels in (("ncsnpp_paired", 16, 6), ("ncsnpp_paired_SR3", 16, 6), ("ncsnpp_2xSR", 8, 15)):
        jconfig, tconfig = configs(CASES[2])
        for c in (jconfig, tconfig):
            c.model.name, c.data.num_channels = name, channels
            c.data.shape_x, c.data.shape_y = [3, 16, 16], [3, y_size, y_size]
            c.data.effective_image_size = y_size
            c.training.lightning_module = "conditional"
        module, params = jax_params(jconfig)
        inputs_ = {"x": x, "y": rng.rand(2, y_size, y_size, 3).astype(np.float32)}
        labels = np.array([10.0, 500.0], np.float32)
        want = as_dict(jax_forward(module, params, inputs_, labels))
        model = create_model(tconfig, device="cpu")
        model.load_state_dict(flax_to_state_dict(params), strict=True)
        got = as_dict(torch_forward(model, inputs_, labels))
        assert sorted(got) == sorted(want), name
        for k in want:
            assert got[k].shape == want[k].shape, name
            np.testing.assert_allclose(got[k], want[k], rtol=5e-4, atol=5e-4, err_msg=name)


@pytest.fixture(scope="module")
def kxsr():
    jconfig, _ = configs(KXSR)
    return jax_params(jconfig)


def test_flax_torch_flax_round_trip_is_exact(kxsr):
    """Every leaf, the Fourier W and (DDPM resblocks with FIR resampling
    convs) conv_w / conv_b included, survives the round trip bit for bit."""
    for case, params in ((KXSR, kxsr[1]), (CASES[5], jax_params(configs(CASES[5])[0])[1])):
        model = create_model(configs(case)[1], device="cpu")
        model.load_state_dict(flax_to_state_dict(params), strict=True)
        back = state_dict_to_flax(model.state_dict())
        flat = lambda t, p="": {  # noqa: E731
            k2: v2 for k, v in t.items() for k2, v2 in (flat(v, p + k + "/").items() if isinstance(v, dict) else [(p + k, v)])
        }
        a, b = flat(params), flat(back)
        assert sorted(a) == sorted(b)
        assert all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in a)
    assert model.down_0.conv_w.shape == (16, 16, 3, 3)  # OIHW here, HWIO in Flax


def test_kernel_path_matches_unfused_path(kxsr):
    """The KxSR toy with ``fused_tail`` and ``fused_block`` (the kernels'
    plain versions on the CPU) against the same weights without them."""
    _, params = kxsr
    x, labels = inputs(KXSR)
    outs = []
    for fused in (True, False):
        model = create_model(configs(KXSR, fused)[1], device="cpu")
        model.load_state_dict(flax_to_state_dict(params), strict=True)
        outs.append(torch_forward(model, x, labels))
    for k in ("x", "y"):
        np.testing.assert_allclose(outs[0][k], outs[1][k], rtol=0, atol=2e-5 * np.abs(outs[1][k]).max())


def test_kernels_fire_where_the_jax_gates_do(monkeypatch):
    """The KxSR toy with the fused knobs on: the port calls the tail, block
    and split kernels and the FIR kernels at the shapes where the JAX model,
    traced with its gates on, calls its Pallas kernels and its FIR
    functions."""
    jconfig, tconfig = configs(KXSR, fused=True)
    module, params = jax_params(jconfig)
    x, labels = inputs(KXSR)
    jax_calls, torch_calls = collections.Counter(), collections.Counter()

    def spy(counter, name, fn, shape_of=lambda a: tuple(a[0].shape)):
        def wrapped(*args, **kwargs):
            counter[(name,) + shape_of(args)] += 1
            return fn(*args, **kwargs)

        return wrapped

    for name, jname in (
        ("gn_silu_conv3x3", "gn_silu_conv3x3_nhwc"),
        ("resblock_fused", "resblock_fused_lowres"),
        ("resblock_fused_split", "resblock_fused_lowres_split"),
    ):
        monkeypatch.setattr(jax_fused, jname, spy(jax_calls, name, getattr(jax_fused, jname)))
        monkeypatch.setattr(layers, name, spy(torch_calls, name, getattr(layers, name)))
    from conditional_score_diffusion_tpu.models import layerspp as jax_layerspp
    from conditional_score_diffusion_tpu.models import ncsnpp as jax_ncsnpp  # noqa: F401

    for name, jname in (("fir_upsample2", "upsample_2d"), ("fir_downsample2", "downsample_2d")):
        monkeypatch.setattr(jax_layerspp, jname, spy(jax_calls, name, getattr(jax_layerspp, jname)))
        monkeypatch.setattr(fir, name, spy(torch_calls, name, getattr(fir, name)))
    jax_forward(module, params, x, labels, fused=True)
    model = create_model(tconfig, device="cpu")
    torch_forward(model, x, labels)
    assert torch_calls == jax_calls
    assert sum(n for k, n in torch_calls.items() if k[0] == "resblock_fused_split") > 0


def test_launch_counts_match_chip_smoke(monkeypatch):
    """The full-width DF2K direct 4x model on the meta device, the kernel
    wrappers stubbed: one forward makes exactly the FIR calls `chip_smoke.py`
    times and expects (15 up, 15 down, at its 20 shapes), and the block
    variant calls kernels 1-3 at the NCSN++ sites it checks."""
    import chip_smoke
    from conditional_score_diffusion_tpu_torch.configs import (
        texture160_kxsr_ncsnpp_block_config,
        texture160_kxsr_ncsnpp_config,
    )

    calls = collections.Counter()

    def stub(name):
        def fn(x, *args, **kwargs):
            B, H, W, C = x.shape
            if name == "fir_upsample2":
                calls[(name, H, C)] += 1
                return torch.empty(B, 2 * H, 2 * W, C, device=x.device)
            if name == "fir_downsample2":
                calls[(name, H, C)] += 1
                return torch.empty(B, H // 2, W // 2, C, device=x.device)
            w = kwargs["w0"] if "w0" in kwargs else args[0]
            cb = args[0].shape[-1] if name == "resblock_fused_split" else 0
            calls[(name, H, C, cb, w.shape[0]) if "w0" in kwargs else (name, H, C)] += 1
            return torch.empty(B, H, W, w.shape[0], device=x.device)

        return fn

    for name in ("gn_silu_conv3x3", "resblock_fused", "resblock_fused_split"):
        monkeypatch.setattr(layers, name, stub(name))
    for name in ("fir_upsample2", "fir_downsample2"):
        monkeypatch.setattr(fir, name, stub(name))
    fir_calls = collections.Counter({(n, h, c): k for n, h, c, k in chip_smoke.FIR_SHAPES})
    for config in (texture160_kxsr_ncsnpp_config(), texture160_kxsr_ncsnpp_block_config()):
        calls.clear()
        model = create_model(config, device="meta")
        x = {"x": torch.empty(8, 160, 160, 3, device="meta"), "y": torch.empty(8, 40, 40, 3, device="meta")}
        with torch.no_grad():
            out = model(x, torch.empty(8, device="meta"))
        assert out["x"].shape == (8, 160, 160, 3) and out["y"].shape == (8, 40, 40, 3)
        assert collections.Counter({k: n for k, n in calls.items() if k[0].startswith("fir")}) == fir_calls
        per_forward = collections.Counter()
        for k, n in calls.items():
            per_forward[k[0]] += n
        assert {k: per_forward[k] for k in chip_smoke.PER_FORWARD_NCSNPP_PATH} == chip_smoke.PER_FORWARD_NCSNPP_PATH
    assert {k[1:] for k in calls if k[0] == "gn_silu_conv3x3"} == set(chip_smoke.NCSNPP_TAIL_SHAPES)
    assert {k for k in calls if k[0].startswith("resblock")} == set(chip_smoke.NCSNPP_BLOCK_SHAPES)
    assert sum(p.numel() for p in model.parameters()) + model.unet.fourier.W.numel() == 32_112_292


def test_kxsr_sampler_matches_jax(kxsr):
    """3 steps of the conditional PC sampler on the KxSR toy (x 32x32, y
    8x8) under the DF2K SDE with sigma_y at the end of its anneal, the JAX
    key chain's noise injected."""
    module, params = kxsr
    jconfig, tconfig = configs(KXSR)
    p_steps, shape = 3, (2, 32, 32, 3)
    y = inputs(KXSR)[0]["y"]
    smin, smax = jax_sigma_y_at_step(jconfig, jconfig.model.reach_target_steps)
    assert (float(smin), float(smax)) == sigma_y_at_step(tconfig, tconfig.model.reach_target_steps)
    jsde, eps = jax_build_sde(jconfig, sigma_min_y=float(smin), sigma_max_y=float(smax))
    key = jax.random.key(11)
    fn = jax_pc.get_conditional_sampling_fn(jconfig, jsde, shape, eps, module, p_steps=p_steps)
    want = np.asarray(fn(key, params, jnp.asarray(y))[0])

    model = create_model(tconfig, device="cpu")
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    tsde, teps = build_sde(tconfig, sigma_min_y=float(smin), sigma_max_y=float(smax))
    tfn = get_conditional_sampling_fn(tconfig, tsde, shape, teps, p_steps=p_steps)
    noise = Replay(jax_sampler_draws(key, p_steps, shape, False, y_shape=y.shape))
    got, _ = tfn(noise, model, torch.from_numpy(y))
    assert not noise.draws and got.shape == shape and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize(
    "case", [c for c in CASES if c[0]] + [KXSR], ids=["-".join(map(str, c)) for c in CASES if c[0]] + ["kxsr"]
)
def test_fir_model_gradients_match_jax_grad(case, monkeypatch):
    """An NCSN++ with ``fir=True`` takes a gradient: every parameter's
    gradient of a weighted sum of its output (train mode, dropout 0) against
    `jax.grad` of the JAX model's.  Where a gradient flows, the factor-2
    resamplings take their plain versions, so `ops/fir.py` sees only the
    calls whose input needs none (the raw input's pyramid); the same forward
    under `no_grad` calls `ops/fir.py` where the JAX model calls its FIR
    functions."""
    jconfig, tconfig = configs(case)
    for c in (jconfig, tconfig):
        c.model.dropout = 0.0
    module, params = jax_params(jconfig)
    x, labels = inputs(case)
    rng = np.random.RandomState(5)
    weights = {k: rng.randn(*v.shape).astype(np.float32) for k, v in as_dict(x).items()}
    weights = weights if isinstance(x, dict) else {"out": weights["out"]}
    jax_calls, torch_calls, grad_inputs = collections.Counter(), collections.Counter(), []
    from conditional_score_diffusion_tpu.models import layerspp as jax_layerspp

    def spy(counter, name, fn):
        def wrapped(a, *args, **kwargs):
            counter[(name, tuple(a.shape))] += 1
            if torch.is_tensor(a) and torch.is_grad_enabled():
                grad_inputs.append(a.requires_grad)
            return fn(a, *args, **kwargs)

        return wrapped

    for name, jname in (("fir_upsample2", "upsample_2d"), ("fir_downsample2", "downsample_2d")):
        monkeypatch.setattr(jax_layerspp, jname, spy(jax_calls, name, getattr(jax_layerspp, jname)))
        monkeypatch.setattr(fir, name, spy(torch_calls, name, getattr(fir, name)))

    def jax_loss(p):
        out = as_dict(module.apply({"params": p}, x, labels, train=True))
        return sum(jnp.sum(out[k] * weights[k]) for k in weights)

    try:
        grads = jax.jit(jax.grad(jax_loss))(params)
    finally:
        reset_jax_dispatch()
    want = flax_to_state_dict(jax.device_get(grads))

    model = create_model(tconfig, device="cpu").train()
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    xt = {k: torch.from_numpy(v) for k, v in x.items()} if isinstance(x, dict) else torch.from_numpy(x)
    out = as_dict(model(xt, torch.from_numpy(labels)))
    sum((out[k] * torch.from_numpy(weights[k])).sum() for k in weights).backward()
    got = {n: p.grad if p.grad is not None else torch.zeros_like(p) for n, p in model.named_parameters()}
    frozen = set(want) - set(got)  # the Fourier projection's W: a buffer here, stop_gradient in JAX
    assert frozen <= {n for n, _ in model.named_buffers()} and all(not want[n].any() for n in frozen)
    hold_gradients(got, {n: want[n] for n in got}, 1e-4)
    assert not any(grad_inputs)  # no gradient-carrying input reached ops/fir.py

    torch_calls.clear()
    with torch.no_grad():
        model(xt, torch.from_numpy(labels))
    assert torch_calls == jax_calls
