"""A forward-only kernel call that autograd cannot pass through quietly.

A ctypes kernel's output is a fresh tensor with no ``grad_fn``, so a loss
built on it would lose the gradient of everything before the call: the
right values and wrong gradients.  :func:`forward_only` runs such a call as
it is when no gradient can flow (grad mode off, or no tensor argument
requires grad); otherwise it runs it inside an autograd Function whose
backward raises `NotImplementedError` naming what is missing, so the graph
stays connected and a backward through it fails loudly.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

import torch


class _ForwardOnly(torch.autograd.Function):
    @staticmethod
    def forward(ctx, message: str, call: Callable[[], torch.Tensor], *tensors: torch.Tensor):
        ctx.message = message
        return call()

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(ctx.message)


def forward_only(name: str, call: Callable[[], torch.Tensor], args: Iterable[Any], why: str = "") -> torch.Tensor:
    """``call()``, whose arguments are ``args`` (entries that are not
    tensors are skipped), with a backward that raises if a gradient would
    flow through it.  ``why`` says where a backward would come from."""
    tensors = [t for t in args if torch.is_tensor(t)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        message = f"{name} has no backward" + (f": {why}" if why else "")
        return _ForwardOnly.apply(message, call, *tensors)
    return call()
