"""Kernels and the numpy resize helper; exports the op entry
`fused_leaky_relu`, as the JAX package's `ops` does."""

from .fused_act import fused_leaky_relu

__all__ = ["fused_leaky_relu"]
