"""Load the reference repo's PyTorch / Lightning checkpoints (JAX
`models/torch_port.py` and `models/torch_port_ncsnpp.py`).

The reference builds each U-Net as one flat ``nn.ModuleList``, so its
state-dict keys are positional (``all_modules.N.*``).  The JAX package
replays the construction order of a config and maps each positional module
onto the named Flax submodule; this module keeps its own numpy copy of that
replay (``_ddpm_slots``, ``_ddpm3d_slots``, ``_ncsnpp_slots``: one slot per
ModuleList index, in order) and of its leaf transposes:

  * ``nn.Linear``    weight (out, in)   -> kernel (in, out); bias
  * ``nn.Conv2d/3d`` weight OIHW/OIDHW  -> kernel HWIO/DHWIO; bias
  * ``nn.GroupNorm`` weight             -> scale; bias
  * ``NIN``          W (in, out), b     -> dense/kernel, dense/bias
  * FIR ``Conv2d``   weight, bias       -> conv_w (HWIO), conv_b
  * Fourier          W                  -> W

The ``port_reference_*`` functions give the Flax-named tree of numpy arrays
that the JAX functions of the same names give;
`models/convert.py:flax_to_state_dict` turns it into the port's state
dict, so no transpose is written twice.  :func:`to_reference_state_dict` is
the same table read the other way (a Flax tree to the reference's keys),
for checkpoints made from seeded weights.

:func:`load_reference_lightning_checkpoint` reads a Lightning ``.ckpt``.
Its ``hyper_parameters`` may pickle classes that are not installed (the
reference's ``ml_collections.ConfigDict``); only the tensors under
``state_dict`` are read.  It tries ``torch.load(weights_only=True)`` first;
where that refuses a class, it unpickles again with the globals on torch's
own ``weights_only`` allowlist (the tensor rebuilders, dtypes,
``collections.OrderedDict``, ...) resolved and every other global, a torch
function such as ``torch.hub.load`` as much as the reference's classes,
replaced by an inert stub: a call of it, or a state set on it, runs no
code.  Load only checkpoints you trust all the same.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .convert import flax_to_state_dict

# A slot: (Flax name, kind); kind "none" is a module without parameters.
Slot = Tuple[str, str]

# Each kind's entries: (path under the Flax node, sub-module of the
# reference module or "", leaf kind, optional).
_ENTRIES = {
    "linear": [((), "", "linear", False)],
    "conv": [((), "", "conv", False)],
    "gn": [((), "", "gn", False)],
    "fourier": [((), "", "fourier", False)],
    "sub_conv": [(("conv",), "Conv_0", "conv", False)],
    "fir_conv": [((), "Conv2d_0", "fir_conv", False)],
    "resblock": [
        (("norm0",), "GroupNorm_0", "gn", False),
        (("conv0",), "Conv_0", "conv", False),
        (("norm1",), "GroupNorm_1", "gn", False),
        (("conv1",), "Conv_1", "conv", False),
        (("temb_proj",), "Dense_0", "linear", True),
        (("shortcut",), "NIN_0", "nin", True),
        (("shortcut",), "Conv_2", "conv", True),
    ],
    "attn": [
        (("norm",), "GroupNorm_0", "gn", False),
        (("q",), "NIN_0", "nin", False),
        (("k",), "NIN_1", "nin", False),
        (("v",), "NIN_2", "nin", False),
        (("out",), "NIN_3", "nin", False),
    ],
    "none": [],
}

# leaf kind -> [(Flax path under the entry, reference leaf, transform)]
_LEAVES = {
    "linear": [(("kernel",), "weight", "T"), (("bias",), "bias", None)],
    "conv": [(("kernel",), "weight", "conv"), (("bias",), "bias", None)],
    "gn": [(("scale",), "weight", None), (("bias",), "bias", None)],
    "nin": [(("dense", "kernel"), "W", None), (("dense", "bias"), "b", None)],
    "fir_conv": [(("conv_w",), "weight", "conv"), (("conv_b",), "bias", None)],
    "fourier": [(("W",), "W", None)],
}


def _to_flax(a: np.ndarray, transform: Optional[str]) -> np.ndarray:
    if transform == "T":
        return np.ascontiguousarray(a.T)
    if transform == "conv":  # OIHW -> HWIO, OIDHW -> DHWIO
        return np.ascontiguousarray(np.moveaxis(a, (0, 1), (-1, -2)))
    return a


def _to_reference(a: np.ndarray, transform: Optional[str]) -> np.ndarray:
    if transform == "T":
        return np.ascontiguousarray(a.T)
    if transform == "conv":
        return np.ascontiguousarray(np.moveaxis(a, (-1, -2), (0, 1)))
    return a


def _join(*parts: str) -> str:
    return ".".join(p for p in parts if p)


def _ddpm_slots(config) -> List[Slot]:
    """Reference `models/ddpm.py:80-147`'s ModuleList, in order."""
    m = config.model
    n = len(m.ch_mult)
    res = [config.data.effective_image_size // 2**i for i in range(n)]
    slots: List[Slot] = [("temb0", "linear"), ("temb1", "linear")] if m.conditional else []
    slots.append(("conv_in", "conv"))
    for lvl in range(n):
        for b in range(m.num_res_blocks):
            slots.append((f"down_{lvl}_{b}", "resblock"))
            if res[lvl] in tuple(m.attn_resolutions):
                slots.append((f"down_attn_{lvl}_{b}", "attn"))
        if lvl != n - 1:
            slots.append((f"down_{lvl}", "sub_conv"))
    slots += [("mid_block0", "resblock"), ("mid_attn", "attn"), ("mid_block1", "resblock")]
    for lvl in reversed(range(n)):
        for b in range(m.num_res_blocks + 1):
            slots.append((f"up_{lvl}_{b}", "resblock"))
        if res[lvl] in tuple(m.attn_resolutions):
            slots.append((f"up_attn_{lvl}", "attn"))
        if lvl != 0:
            slots.append((f"up_{lvl}", "sub_conv"))
    return slots + [("norm_out", "gn"), ("conv_out", "conv")]


def _ddpm3d_slots(config) -> List[Slot]:
    """Reference `models/ddpm3D.py:38-195`: no attention; its resamplers
    hold parameters only with ``resamp_with_conv`` and take an index either
    way."""
    m = config.model
    n = len(m.ch_mult)
    resample = "sub_conv" if m.resamp_with_conv else "none"
    slots: List[Slot] = [("temb0", "linear"), ("temb1", "linear")] if m.conditional else []
    slots.append(("conv_in", "conv"))
    for lvl in range(n):
        slots += [(f"down_{lvl}_{b}", "resblock") for b in range(m.num_res_blocks)]
        if lvl != n - 1:
            slots.append((f"down_{lvl}", resample))
    slots += [("mid_block0", "resblock"), ("mid_block1", "resblock")]
    for lvl in reversed(range(n)):
        slots += [(f"up_{lvl}_{b}", "resblock") for b in range(m.num_res_blocks + 1)]
        if lvl != 0:
            slots.append((f"up_{lvl}", resample))
    return slots + [("norm_out", "gn"), ("conv_out", "conv")]


def _ncsnpp_slots(config) -> List[Slot]:
    """Reference `models/ncsnpp.py:74-236`: the order depends on the
    embedding, the block type and the progressive modes."""
    m = config.model
    n = len(m.ch_mult)
    res = [config.data.effective_image_size // 2**i for i in range(n)]
    ddpm_blocks = m.resblock_type.lower() == "ddpm"
    progressive, progressive_input = m.progressive.lower(), m.progressive_input.lower()
    resample = "fir_conv" if m.fir else "sub_conv"
    slots: List[Slot] = [("fourier", "fourier")] if m.embedding_type.lower() == "fourier" else []
    if m.conditional:
        slots += [("temb0", "linear"), ("temb1", "linear")]
    slots.append(("conv_in", "conv"))
    for lvl in range(n):
        for b in range(m.num_res_blocks):
            slots.append((f"down_{lvl}_{b}", "resblock"))
            if res[lvl] in tuple(m.attn_resolutions):
                slots.append((f"down_attn_{lvl}_{b}", "attn"))
        if lvl != n - 1:
            slots.append((f"down_{lvl}", resample if ddpm_blocks else "resblock"))
            if progressive_input == "input_skip":
                slots.append((f"combine_{lvl}", "sub_conv"))
            elif progressive_input == "residual":
                slots.append((f"pyr_down_{lvl}", resample))
    slots += [("mid_block0", "resblock"), ("mid_attn", "attn"), ("mid_block1", "resblock")]
    for lvl in reversed(range(n)):
        for b in range(m.num_res_blocks + 1):
            slots.append((f"up_{lvl}_{b}", "resblock"))
        if res[lvl] in tuple(m.attn_resolutions):
            slots.append((f"up_attn_{lvl}", "attn"))
        if progressive != "none":
            if lvl == n - 1 or progressive == "output_skip":
                slots += [(f"pyr_norm_{lvl}", "gn"), (f"pyr_conv_{lvl}", "conv")]
            else:
                slots.append((f"pyr_up_{lvl}", resample))
        if lvl != 0:
            slots.append((f"up_{lvl}", resample if ddpm_blocks else "resblock"))
    if progressive != "output_skip":
        slots += [("norm_out", "gn"), ("conv_out", "conv")]
    return slots


def _get(tree: Mapping, path) -> Optional[Mapping]:
    for p in path:
        if not isinstance(tree, Mapping) or p not in tree:
            return None
        tree = tree[p]
    return tree


def _set(tree: Dict, path, value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def _from_reference(sd: Mapping, slots: List[Slot]) -> Dict:
    """The reference state dict ``sd`` (``all_modules.N.*``) -> the Flax tree."""
    sd = {k: np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v) else v) for k, v in sd.items()}
    params: Dict = {}
    for idx, (name, kind) in enumerate(slots):
        for path, sub, leaf_kind, optional in _ENTRIES[kind]:
            prefix = _join(f"all_modules.{idx}", sub)
            first = _LEAVES[leaf_kind][0][1]
            if optional and f"{prefix}.{first}" not in sd:
                continue
            for leaf_path, ref_leaf, transform in _LEAVES[leaf_kind]:
                _set(params, (name, *path, *leaf_path), _to_flax(sd[f"{prefix}.{ref_leaf}"], transform))
    left = sorted(k for k in sd if k.startswith("all_modules.") and int(k.split(".")[1]) >= len(slots))
    if left:
        raise KeyError(f"unconsumed reference modules from index {len(slots)}: {left[:4]}")
    return params


def _slots(config) -> List[Slot]:
    name = config.model.name
    if name in ("ddpm", "ddpm_paired", "ddpm_paired_SR3", "ddpm_2xSR", "ddpm_KxSR"):
        return _ddpm_slots(config)
    if name in ("ddpm3D", "ddpm3D_paired", "ddpm3D_paired_SR3"):
        return _ddpm3d_slots(config)
    if name in ("ncsnpp", "ncsnpp_paired", "ncsnpp_paired_SR3", "ncsnpp_2xSR", "ncsnpp_KxSR"):
        return _ncsnpp_slots(config)
    raise NotImplementedError(f"porter for model {name!r} not implemented yet")


def _paired(config) -> bool:
    return config.model.name not in ("ddpm", "ddpm3D", "ncsnpp")


def port_reference_ddpm_state_dict(sd: Mapping, config) -> Dict:
    """A reference DDPM state dict -> the Flax tree of `models/ddpm.py:DDPM`."""
    return _from_reference(sd, _ddpm_slots(config))


def port_reference_ddpm3d_state_dict(sd: Mapping, config) -> Dict:
    """A reference DDPM3D state dict -> the Flax tree of `models/ddpm3d.py:DDPM3D`."""
    return _from_reference(sd, _ddpm3d_slots(config))


def port_reference_ddpm_paired(sd: Mapping, config) -> Dict:
    """The paired variants wrap the same U-Net, nested under ``unet``."""
    return {"unet": port_reference_ddpm_state_dict(sd, config)}


def port_reference_ncsnpp_state_dict(sd: Mapping, config) -> Dict:
    """A reference NCSN++ state dict -> the Flax tree of `models/ncsnpp.py:NCSNpp`."""
    return _from_reference(sd, _ncsnpp_slots(config))


def port_reference_ncsnpp_paired(sd: Mapping, config) -> Dict:
    return {"unet": port_reference_ncsnpp_state_dict(sd, config)}


def to_reference_state_dict(params: Mapping, config) -> Dict[str, torch.Tensor]:
    """A Flax tree of the config's model (``unet``-nested for a paired
    one) -> the reference's positional state dict (float32 CPU tensors)."""
    if _paired(config):
        params = params["unet"]
    sd: Dict[str, torch.Tensor] = {}
    for idx, (name, kind) in enumerate(_slots(config)):
        node = params.get(name)
        for path, sub, leaf_kind, optional in _ENTRIES[kind]:
            entry = _get(node, path)
            if entry is None:
                if optional:
                    continue
                raise KeyError(f"{name}/{'/'.join(path)} missing for all_modules.{idx}")
            if path == ("shortcut",) and (leaf_kind == "nin") != ("dense" in entry):
                continue  # the other kind of shortcut
            for leaf_path, ref_leaf, transform in _LEAVES[leaf_kind]:
                value = np.asarray(_get(entry, leaf_path))
                sd[f"{_join(f'all_modules.{idx}', sub)}.{ref_leaf}"] = torch.from_numpy(_to_reference(value, transform))
    return sd


class _Stub:
    """Stands for a class of a checkpoint that is not torch's: takes any
    arguments and state and does nothing."""

    def __init__(self, *args, **kwargs):
        self.args, self.kwargs = args, kwargs

    def __setstate__(self, state):
        self.state = state

    def __setitem__(self, key, value):
        pass

    def append(self, value):
        pass

    def extend(self, values):
        pass


class _StubUnpickler(pickle.Unpickler):
    """Resolves the globals that ``torch.load(weights_only=True)`` allows;
    every other global becomes a subclass of :class:`_Stub`."""

    def find_class(self, module, name):
        from torch._weights_only_unpickler import _get_allowed_globals

        allowed = _get_allowed_globals().get(f"{module}.{name}")
        if allowed is not None:
            return allowed
        return type(name, (_Stub,), {"__module__": f"stub:{module}"})


class _StubPickle:
    """The ``pickle_module`` of `torch.load` with :class:`_StubUnpickler`."""

    Unpickler = _StubUnpickler
    load = staticmethod(pickle.load)


def _load_ckpt(path: str) -> Mapping:
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        return torch.load(path, map_location="cpu", weights_only=False, pickle_module=_StubPickle)


def load_reference_lightning_checkpoint(path: str, config, model: Optional[torch.nn.Module] = None
                                        ) -> Dict[str, torch.Tensor]:
    """The port's state dict of a reference Lightning ``.ckpt`` (or a bare
    state dict file): the tensors under ``state_dict`` with the
    ``score_model.`` prefix stripped, ported by ``config.model.name`` as
    the JAX loader dispatches, through `convert.flax_to_state_dict`.
    Where ``model`` is given the weights are loaded into it (``strict=True``)."""
    ckpt = _load_ckpt(path)
    sd = ckpt.get("state_dict", ckpt)
    sd = {k[len("score_model."):]: v for k, v in sd.items() if k.startswith("score_model.")} or dict(sd)
    params = _from_reference(sd, _slots(config))
    state = flax_to_state_dict({"unet": params} if _paired(config) else params)
    if model is not None:
        model.load_state_dict(state, strict=True)
    return state
