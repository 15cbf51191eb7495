"""Weight bridge between the JAX package's Flax ``params`` tree and this
port's ``state_dict``.

Module names are the same on both sides (`models/ddpm.py`,
`models/ncsnpp.py`), so the bridge only renames leaves and transposes them:

  * conv ``kernel`` HWIO          <-> ``weight`` OIHW (3x3 and 1x1 convs)
  * 3-D conv ``kernel`` DHWIO     <-> ``weight`` OIDHW (`models/ddpm3d.py`)
  * dense ``kernel`` (in, out)    <-> ``weight`` (out, in)   (Dense, NIN,
    SplitNIN: ``.../dense/kernel``; the FCN's ``Dense_i`` <-> its
    ``nn.Linear`` ``Dense_i``)
  * GroupNorm ``scale`` (C,)      <-> ``weight`` (C,)
  * ``bias``                      <-> ``bias``
  * NCSN++ Fourier ``W`` (C,)     <-> the buffer ``W``
  * FIR resampler ``conv_w`` HWIO <-> ``conv_w`` OIHW, ``conv_b`` <-> ``conv_b``
  * the NCSN norms' ``alpha`` / ``gamma`` / ``beta`` (C,) and their
    class tables ``embed/embedding`` (classes, k C) as they are
    (`models/normalization.py`); NCSN's dilated convs are plain conv
    ``kernel``s

The split banks (SplitGroupNorm, SplitConv3x3, SplitConv1x1, SplitNIN) hold
the same parameters as their joint modules, so they need nothing of their
own.  The Flax tree is taken as nested dicts of numpy arrays
(``jax.device_get``).  :func:`load_jax_train_state` carries a whole JAX
train state over: parameters, EMA, Adam's moments and the schedule.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


# leaves carried under their own name, unchanged
_AS_IS = ("W", "conv_b", "alpha", "gamma", "beta", "embedding")


def _leaf_to_torch(name: str, value: np.ndarray):
    if name in ("kernel", "conv_w") and value.ndim == 4:
        return "weight" if name == "kernel" else name, np.transpose(value, (3, 2, 0, 1))
    if name == "kernel" and value.ndim == 5:
        return "weight", np.transpose(value, (4, 3, 0, 1, 2))
    if name in _AS_IS:
        return name, value
    if name == "kernel" and value.ndim == 2:
        return "weight", value.T
    if name == "scale":
        return "weight", value
    if name == "bias":
        return "bias", value
    raise KeyError(f"no torch counterpart for Flax leaf {name!r} of shape {value.shape}")


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params (nested dicts of arrays) -> a torch ``state_dict``."""
    out = {}

    def walk(tree, prefix):
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, prefix + (key,))
            else:
                leaf, arr = _leaf_to_torch(key, np.asarray(value))
                out[".".join(prefix + (leaf,))] = torch.from_numpy(np.array(arr))  # a writable copy

    walk(params, ())
    return out


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """A torch ``state_dict`` -> Flax params (nested dicts of numpy arrays)."""
    params: Dict = {}
    for key, tensor in state_dict.items():
        *path, leaf = key.split(".")
        arr = tensor.detach().cpu().numpy()
        if leaf in ("weight", "conv_w") and arr.ndim == 4:
            leaf, arr = "kernel" if leaf == "weight" else leaf, np.transpose(arr, (2, 3, 1, 0))
        elif leaf == "weight" and arr.ndim == 5:
            leaf, arr = "kernel", np.transpose(arr, (2, 3, 4, 1, 0))
        elif leaf == "weight" and arr.ndim == 2:
            leaf, arr = "kernel", arr.T
        elif leaf == "weight" and arr.ndim == 1:
            leaf = "scale"
        elif leaf != "bias" and leaf not in _AS_IS:
            raise KeyError(f"no Flax counterpart for {key!r}")
        node = params
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(arr)
    return params


def load_jax_train_state(state, jax_state: Mapping) -> None:
    """Carry a JAX `TrainState` over into the port's `training.state.TrainState`
    ``state`` (built from the same recipe), in place.

    ``jax_state`` holds the JAX state's pieces as numpy arrays (the caller
    takes them out of the optax tree with `jax.device_get`):

    * ``step``; ``params`` (the Flax tree);
    * ``ema``: ``{'decay', 'num_updates', 'params'}``;
    * ``adam``: optax ``ScaleByAdamState`` as ``{'count', 'mu', 'nu'}`` (mu
      and nu Flax trees), which become `torch.optim.Adam`'s per-parameter
      ``exp_avg``, ``exp_avg_sq`` and ``step``;
    * ``schedule_count``: ``ScaleByScheduleState.count``, the warmup
      schedule's position, which becomes the `LambdaLR`'s.

    A leaf JAX trains as a frozen parameter (NCSN++'s Fourier ``W``, under
    ``stop_gradient``) is a buffer here: the params entry sets it, and its
    EMA copy and Adam moments are checked (the same ``W``; zero moments)
    instead of carried.
    """
    model = state.model
    model.load_state_dict(flax_to_state_dict(jax_state["params"]), strict=True)
    buffers = dict(model.named_buffers())
    ema = jax_state["ema"]
    with torch.no_grad():
        for name, value in flax_to_state_dict(ema["params"]).items():
            if name in state.ema.params:
                state.ema.params[name].copy_(value)
            elif not torch.equal(buffers[name].cpu(), value):
                raise ValueError(f"the EMA's {name} differs from the params' (a frozen buffer here)")
    state.ema.decay = float(ema["decay"])
    state.ema.num_updates = int(ema["num_updates"])

    adam = jax_state["adam"]
    mu, nu = flax_to_state_dict(adam["mu"]), flax_to_state_dict(adam["nu"])
    count = int(adam["count"])
    for name in set(mu) - {n for n, _ in model.named_parameters()}:
        if mu[name].any() or nu[name].any():  # a frozen leaf's moments stay 0 (its gradient is 0)
            raise ValueError(f"Adam moments of {name}, a buffer here, are not zero")
    for name, p in model.named_parameters():
        state.optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": mu[name].to(p.device, p.dtype),
            "exp_avg_sq": nu[name].to(p.device, p.dtype),
        }
    sched = state.scheduler
    sched.last_epoch = int(jax_state["schedule_count"])
    for group, lr_lambda in zip(state.optimizer.param_groups, sched.lr_lambdas):
        group["lr"] = group["initial_lr"] * lr_lambda(sched.last_epoch)
    sched._last_lr = [group["lr"] for group in state.optimizer.param_groups]
    state.step = int(jax_state["step"])
