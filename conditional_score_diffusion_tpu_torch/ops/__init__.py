"""Kernels and the numpy resize helper."""
