"""Score-network models (PyTorch, NHWC) and their registry."""

from __future__ import annotations

import torch
import torch.nn as nn

from .. import registry

register_model = registry.models.register
get_model = registry.models.get


def create_model(config, device="cuda") -> nn.Module:
    """The model named by ``config.model.name``, built on ``device`` with
    its default init (DDPM's, or Flax's Dense init for ``fcn``; from torch's
    default generator), in eval mode;
    its kernel call sites follow the recipe's ``model.fused_tail`` /
    ``model.fused_block`` and its 3x3 convs ``model.conv_dispatch``
    (`layers.CONV_POLICIES`)."""
    from .layers import apply_conv_dispatch

    cls = get_model(config.model.name)
    with torch.device(device):
        model = cls.from_config(config)
    apply_conv_dispatch(model, config.model.get("conv_dispatch", "none"))
    return model.eval()


def init_model_random(config, seed: int = 0, scale: float = 0.02, device="cuda") -> nn.Module:
    """Counterpart of the JAX `init_model_shapes_only`: the model with every
    parameter drawn from N(0, scale) by a generator seeded with ``seed``,
    except GroupNorm scales (ones), biases (zeros, and the NCSN norms'
    ``beta``) and the NCSN norms' scales and class tables (``alpha``,
    ``gamma``, ``embedding``: 1 + N(0, scale), their own init's form, so a
    norm does not scale its output by ~``scale``).

    The DDPM init zeroes every conv1 and conv_out, so a freshly initialized
    network outputs exactly 0 and the Langevin corrector, which divides by
    the score's norm, steps to inf.  Random weights for a run without a
    checkpoint therefore come from here.
    """
    model = create_model(config, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    # the NCSN++ Fourier projection's frozen W is a buffer here, a parameter in JAX
    fourier = [(n, b) for n, b in model.named_buffers() if n.rsplit(".", 1)[-1] == "W"]
    with torch.no_grad():
        for name, p in list(model.named_parameters()) + fourier:
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "weight" and p.ndim == 1:  # GroupNorm scale
                p.fill_(1.0)
            elif leaf in ("bias", "beta"):
                p.zero_()
            elif leaf in ("alpha", "gamma", "embedding"):
                p.normal_(1.0, scale, generator=gen)
            else:
                p.normal_(0.0, scale, generator=gen)
    return model


# Side-effect imports fill the registry.
from . import ddpm  # noqa: E402,F401
from . import ddpm3d  # noqa: E402,F401
from . import fcn  # noqa: E402,F401
from . import ncsnpp  # noqa: E402,F401
from . import ncsnv2  # noqa: E402,F401

__all__ = ["register_model", "get_model", "create_model", "init_model_random"]
