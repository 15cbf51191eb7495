"""Predictor: one reverse-diffusion step (JAX `sampling/predictors.py`).

``update(noise, x, t, *, sde, score_fn, probability_flow=False, y=None)
-> (x, x_mean)``, where ``noise(shape)`` returns standard normal values on
the device of ``x``.  The conditional registry name aliases the same
function; ``score_fn`` takes ``(x, y, t)`` when ``y`` is passed.
"""

from __future__ import annotations

from .. import registry
from ..sde import batch_mul

register_predictor = registry.predictors.register
get_predictor = registry.predictors.get


@register_predictor(name="reverse_diffusion")
def reverse_diffusion(noise, x, t, *, sde, score_fn, probability_flow=False, y=None):
    rsde = sde.reverse(score_fn, probability_flow)
    f, G = rsde.discretize(x, t, y)
    z = noise(x.shape)
    x_mean = x - f
    x = x_mean + batch_mul(G, z)
    return x, x_mean


registry.predictors.register(reverse_diffusion, name="conditional_reverse_diffusion")
