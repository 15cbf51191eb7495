"""Toy MLP score network for 2-D synthetic data (JAX `models/fcn.py`): the
time concatenated to the state, a ReLU MLP with dropout after each hidden
dense layer.

The dense layers are named as Flax names them (``Dense_0`` ...
``Dense_{hidden_layers + 1}``), so `models/convert.py` carries the JAX
params over by its Dense rule.  The default init is Flax's ``nn.Dense``
init: kernels from LeCun normal (variance scaling 1, fan in, a normal
truncated at two standard deviations), biases 0, drawn from torch's
default generator.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import register_model

# std of a standard normal truncated to [-2, 2] (jax.nn.initializers.variance_scaling)
_TRUNCATED_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor) -> torch.Tensor:
    """Flax ``lecun_normal`` on a torch ``(out, in)`` weight, in place."""
    std = math.sqrt(1.0 / weight.shape[1]) / _TRUNCATED_STD
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std)


def _dense(in_dim: int, out_dim: int) -> nn.Linear:
    layer = nn.Linear(in_dim, out_dim)
    with torch.no_grad():
        lecun_normal_(layer.weight)
        layer.bias.zero_()
    return layer


@register_model(name="fcn")
class FCN(nn.Module):
    def __init__(self, state_size: int, hidden_layers: int, hidden_nodes: int, dropout: float):
        super().__init__()
        dims = [state_size + 1] + [hidden_nodes] * (hidden_layers + 1)
        for i in range(hidden_layers + 1):
            self.add_module(f"Dense_{i}", _dense(dims[i], dims[i + 1]))
        self.add_module(f"Dense_{hidden_layers + 1}", _dense(hidden_nodes, state_size))
        self.hidden_layers = hidden_layers
        self.dropout = dropout

    @classmethod
    def from_config(cls, config):
        m = config.model
        return cls(
            state_size=m.state_size, hidden_layers=m.hidden_layers, hidden_nodes=m.hidden_nodes, dropout=m.dropout
        )

    def forward(self, x, t):
        h = torch.cat([x, t[:, None].to(x.dtype)], dim=1)
        for i in range(self.hidden_layers + 1):
            h = getattr(self, f"Dense_{i}")(h)
            h = F.relu(F.dropout(h, self.dropout, self.training))
        return getattr(self, f"Dense_{self.hidden_layers + 1}")(h)
