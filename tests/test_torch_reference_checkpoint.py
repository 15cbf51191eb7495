"""The port's reference-checkpoint loaders (`models/reference_checkpoint.py`)
against the JAX porters (`models/torch_port.py`, `models/torch_port_ncsnpp.py`).

For each model family a toy port model with seeded weights gives a Flax
tree (`convert.state_dict_to_flax`, exact); `to_reference_state_dict` lays
it out as the reference's positional ``all_modules.N.*`` keys.  On that
state dict the port's porter, and the whole ``.ckpt`` loader, must give
exactly JAX's porter followed by `flax_to_state_dict` (the JAX porter reads
the port's config, which has the fields it reads), and the tree it started
from.  The checkpoint pickles a ``hyper_parameters`` object of a class that
cannot be imported, as a Lightning checkpoint of the reference pickles its
``ml_collections.ConfigDict``.  One forward per family, through a loaded
checkpoint, against JAX's on the same weights: DDPM 7e-6, NCSN++ 5e-4 of
the output's largest magnitude.
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_toy import (
    jax_init_params,
    jax_toy_config,
    jax_toy_params,
    ncsnpp_toy_config,
    torch_toy_config,
)
from conditional_score_diffusion_tpu.configs import base as jax_base
from conditional_score_diffusion_tpu.models import torch_port as jax_port
from conditional_score_diffusion_tpu.models import torch_port_ncsnpp as jax_port_ncsnpp
from conditional_score_diffusion_tpu_torch.configs import base as torch_base
from conditional_score_diffusion_tpu_torch.configs import mri_to_pet_config
from conditional_score_diffusion_tpu_torch.models import create_model, init_model_random
from conditional_score_diffusion_tpu_torch.models import reference_checkpoint as ref
from conditional_score_diffusion_tpu_torch.models.convert import flax_to_state_dict, state_dict_to_flax

torch.set_num_threads(1)

DDPM_TOL, NCSNPP_TOL = 7e-6, 5e-4


def _ddpm3d(paired: bool):
    c = mri_to_pet_config(True, "ours_DV")
    d, m = c.data, c.model
    d.image_size = d.effective_image_size = 16
    d.shape_x, d.shape_y = [1, 16, 16, 8], [1, 16, 16, 8]
    m.nf, m.ch_mult, m.num_res_blocks, m.dropout, m.resamp_with_conv = 8, (1, 2), 1, 0.0, True
    if not paired:
        m.name, m.input_channels, m.output_channels = "ddpm3D", 1, 1
    return c


def _ncsnpp(name, fir, progressive, progressive_input, resblock_type, embedding_type):
    c = ncsnpp_toy_config(torch_base, embedding_type=embedding_type, fir=fir)
    m = c.model
    m.progressive, m.progressive_input, m.resblock_type = progressive, progressive_input, resblock_type
    if name == "ncsnpp_paired":
        m.name, c.data.num_channels = name, 6
        c.data.shape_x = c.data.shape_y = [3, 16, 16]
        c.training.lightning_module = "conditional"
    return c


def _ddpm_unpaired():
    c = ncsnpp_toy_config(torch_base, name="ddpm")
    c.model.input_channels = c.model.output_channels = 3
    return c


CASES = {
    "ddpm": _ddpm_unpaired,
    "ddpm_paired": lambda: torch_toy_config(fused_tail=False),
    "ddpm3D": lambda: _ddpm3d(False),
    "ddpm3D_paired": lambda: _ddpm3d(True),
    "ncsnpp": lambda: _ncsnpp("ncsnpp", True, "residual", "residual", "ddpm", "positional"),
    "ncsnpp_fourier_biggan": lambda: _ncsnpp("ncsnpp", True, "output_skip", "input_skip", "biggan", "fourier"),
    "ncsnpp_paired": lambda: _ncsnpp("ncsnpp_paired", False, "none", "none", "biggan", "positional"),
}


def _jax_port(sd, config):
    """The JAX loader's dispatch (`torch_port.py:load_reference_lightning_checkpoint`)."""
    name = config.model.name
    if name == "ddpm":
        return jax_port.port_reference_ddpm_state_dict(sd, config)
    if name == "ddpm_paired":
        return jax_port.port_reference_ddpm_paired(sd, config)
    if name == "ddpm3D":
        return jax_port.port_reference_ddpm3d_state_dict(sd, config)
    if name == "ddpm3D_paired":
        return {"unet": jax_port.port_reference_ddpm3d_state_dict(sd, config)}
    if name == "ncsnpp":
        return jax_port_ncsnpp.port_reference_ncsnpp_state_dict(sd, config)
    return jax_port_ncsnpp.port_reference_ncsnpp_paired(sd, config)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _assert_same_state(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def _unimportable_hparams():
    """An object whose class lives in a module that exists only while it
    is pickled (the reference's ConfigDict on a machine without ml_collections)."""
    mod = types.ModuleType("csdt_absent_hparams")

    class ConfigDict:
        def __init__(self):
            self.model = {"name": "ddpm_paired", "nf": 32}

    ConfigDict.__module__ = mod.__name__
    ConfigDict.__qualname__ = "ConfigDict"
    mod.ConfigDict = ConfigDict
    return mod, ConfigDict()


def write_ckpt(path, sd):
    """A Lightning-style checkpoint: ``score_model.`` keys, a top-level
    buffer the porters ignore, and unimportable hyper-parameters."""
    mod, hparams = _unimportable_hparams()
    state = {f"score_model.{k}": v for k, v in sd.items()}
    state["score_model.sigmas"] = torch.linspace(0.01, 50.0, 10)
    sys.modules[mod.__name__] = mod
    try:
        torch.save({"state_dict": state, "hyper_parameters": hparams, "epoch": 3}, path)
    finally:
        del sys.modules[mod.__name__]


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_matches_jax_porter_exactly(case, tmp_path):
    config = CASES[case]()
    model = init_model_random(config, seed=3, device="cpu")
    params = state_dict_to_flax(model.state_dict())
    sd = ref.to_reference_state_dict(params, config)
    assert all(k.startswith("all_modules.") for k in sd)
    want = flax_to_state_dict(_jax_port({k: v.numpy() for k, v in sd.items()}, config))
    _assert_same_state(want, model.state_dict())  # the reference layout carries every tensor

    port = getattr(ref, {
        "ddpm": "port_reference_ddpm_state_dict", "ddpm_paired": "port_reference_ddpm_paired",
        "ddpm3D": "port_reference_ddpm3d_state_dict", "ncsnpp": "port_reference_ncsnpp_state_dict",
        "ncsnpp_paired": "port_reference_ncsnpp_paired",
    }.get(config.model.name, "port_reference_ddpm3d_state_dict"))
    tree = port(sd, config)
    if config.model.name == "ddpm3D_paired":
        tree = {"unet": tree}
    _assert_same_state(flax_to_state_dict(tree), want)

    path = tmp_path / "model.ckpt"
    write_ckpt(path, sd)
    with pytest.raises(Exception):  # torch's safe loader refuses the unknown class
        torch.load(path, map_location="cpu", weights_only=True)
    fresh = create_model(config, device="cpu")
    loaded = ref.load_reference_lightning_checkpoint(str(path), config, model=fresh)
    _assert_same_state(loaded, want)
    _assert_same_state(fresh.state_dict(), want)


def test_unconsumed_modules_raise():
    config = CASES["ddpm_paired"]()
    params = state_dict_to_flax(init_model_random(config, seed=3, device="cpu").state_dict())
    sd = ref.to_reference_state_dict(params, config)
    n = 1 + max(int(k.split(".")[1]) for k in sd)
    sd[f"all_modules.{n}.weight"] = torch.zeros(3)
    with pytest.raises(KeyError, match="unconsumed"):
        ref.port_reference_ddpm_paired(sd, config)


def test_bare_state_dict_file_loads(tmp_path):
    """A file holding the state dict itself, without ``score_model.``."""
    config = CASES["ddpm"]()
    model = init_model_random(config, seed=4, device="cpu")
    sd = ref.to_reference_state_dict(state_dict_to_flax(model.state_dict()), config)
    torch.save(sd, tmp_path / "sd.pt")
    _assert_same_state(ref.load_reference_lightning_checkpoint(str(tmp_path / "sd.pt"), config), model.state_dict())


class _Hostile:
    """Pickles as a call of ``torch.hub.load``, a torch function that runs
    code, with arguments that would fail if it ran."""

    def __reduce__(self):
        return torch.hub.load, ("csdt-absent/repo", "absent_model")


def test_stub_unpickler_runs_no_torch_callable(tmp_path, monkeypatch):
    """A ``.ckpt`` that ``weights_only=True`` refuses and whose pickle names
    ``torch.hub.load``: the fallback gives a stub in its place, and never
    calls the function; the tensors load."""
    mod, hparams = _unimportable_hparams()
    sys.modules[mod.__name__] = mod
    try:
        torch.save({"state_dict": {"score_model.w": torch.arange(3.0)}, "hyper_parameters": hparams,
                    "hook": _Hostile()}, tmp_path / "h.ckpt")
    finally:
        del sys.modules[mod.__name__]
    with pytest.raises(Exception):
        torch.load(tmp_path / "h.ckpt", map_location="cpu", weights_only=True)
    called = []
    monkeypatch.setattr(torch.hub, "load", lambda *a, **k: called.append(a))
    ckpt = ref._load_ckpt(str(tmp_path / "h.ckpt"))
    assert called == []
    assert isinstance(ckpt["hook"], ref._Stub) and type(ckpt["hook"]).__module__ == "stub:torch.hub"
    assert ckpt["hook"].args == ("csdt-absent/repo", "absent_model")
    assert isinstance(ckpt["hyper_parameters"], ref._Stub)
    assert torch.equal(ckpt["state_dict"]["score_model.w"], torch.arange(3.0))


def _forward_case(family):
    if family == "ddpm":
        jconfig, tconfig = jax_toy_config(fused_tail=False), torch_toy_config(fused_tail=False)
        module, params = jax_toy_params(jconfig)
        rng = np.random.RandomState(0)
        inputs = {"x": rng.rand(2, 32, 32, 3).astype(np.float32), "y": rng.rand(2, 32, 32, 3).astype(np.float32)}
        labels = np.array([10.0, 700.0], np.float32)
        return tconfig, module, params, inputs, labels, DDPM_TOL
    jconfig, tconfig = ncsnpp_toy_config(jax_base), ncsnpp_toy_config(torch_base)
    module, params = jax_init_params(jconfig)
    rng = np.random.RandomState(0)
    return tconfig, module, params, rng.rand(2, 16, 16, 3).astype(np.float32), np.array([10.0, 500.0], np.float32), NCSNPP_TOL


@pytest.mark.parametrize("family", ["ddpm", "ncsnpp"])
def test_forward_through_a_checkpoint_matches_jax(family, tmp_path):
    tconfig, module, params, inputs, labels, tol = _forward_case(family)
    write_ckpt(tmp_path / "m.ckpt", ref.to_reference_state_dict(params, tconfig))
    model = create_model(tconfig, device="cpu")
    ref.load_reference_lightning_checkpoint(str(tmp_path / "m.ckpt"), tconfig, model=model)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()} if isinstance(inputs, dict) else jnp.asarray(inputs)
    want = module.apply({"params": params}, jin, jnp.asarray(labels), train=False)
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()} if isinstance(inputs, dict) else torch.from_numpy(inputs)
    with torch.no_grad():
        got = model(tin, torch.from_numpy(labels))
    want = want if isinstance(want, dict) else {"x": want}
    got = got if isinstance(got, dict) else {"x": got}
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(jax.device_get(want[k]))
        err = np.abs(got[k].numpy() - w).max() / np.abs(w).max()
        print(f"{family} {k}: max error {err:.3e} of the largest magnitude")
        assert err <= tol, (k, err)
