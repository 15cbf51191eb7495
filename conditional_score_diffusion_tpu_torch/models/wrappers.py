"""Score-function wrappers: raw network output -> time-dependent score
(JAX `models/wrappers.py`; the continuous VE and multi-speed branches).

The model is fed ``labels = t * (N - 1)`` and its output is divided by the
marginal std of each domain.
"""

from __future__ import annotations

import copy
from typing import Callable, Mapping, Optional

import torch

from ..sde import VESDE, batch_mul, is_multispeed


def _map(fn, tree):
    return {k: fn(v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def get_model_fn(
    model: torch.nn.Module,
    train: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    params: Optional[Mapping[str, torch.Tensor]] = None,
) -> Callable:
    """``model_fn(inputs, labels)``: the raw network (``inputs`` a tensor or a
    dict of tensors), in train or eval mode, without autograd in eval.

    The mode is set around each call and the module's own mode restored
    after it, so a score built from a live model (an eval loss, a sampler
    built mid-training) leaves the caller's module as it was: JAX applies a
    stateless module.

    ``params``: run the module with these tensors in place of its own
    parameters (`torch.func.functional_call`), as JAX applies a module to a
    params tree (the EMA weights of an eval loss).

    ``compute_dtype`` (e.g. ``torch.bfloat16``): run a copy of ``model``
    with its parameters cast to that type (the caller's module is left as
    it is), cast the inputs to it, and cast the outputs back to float32, so
    the score division and all sampler math stay float32.  ``labels`` are
    not cast: the timestep embedding is taken in float32 and then cast to
    the activations' type.
    """
    if compute_dtype is not None:
        model = copy.deepcopy(model).to(compute_dtype)
        if params is not None:
            params = {k: v.to(compute_dtype) for k, v in params.items()}

    def model_fn(inputs, labels):
        if compute_dtype is not None:
            inputs = _map(lambda x: x.to(compute_dtype), inputs)
        mode = model.training
        model.train(train)
        try:
            with torch.set_grad_enabled(train and torch.is_grad_enabled()):
                if params is None:
                    out = model(inputs, labels)
                else:
                    out = torch.func.functional_call(model, params, (inputs, labels))
        finally:
            model.train(mode)
        if compute_dtype is not None:
            out = _map(lambda x: x.float(), out)
        return out

    return model_fn


def _divide_by_std_continuous(h, t, sde):
    if is_multispeed(sde) and isinstance(h, dict):
        return {
            domain: batch_mul(1.0 / sde[domain].marginal_prob(None, t)[1], h[domain])
            for domain in h
        }
    return batch_mul(1.0 / sde.marginal_prob(None, t)[1], h)


def get_score_fn(
    sde,
    model,
    conditional: bool = False,
    train: bool = False,
    continuous: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    params: Optional[Mapping[str, torch.Tensor]] = None,
) -> Callable:
    """``score_fn(inputs, t)`` of a conditional model under a continuous-time
    multi-speed VE (or single VE) SDE; ``inputs`` is ``{'x': ..., 'y': ...}``
    and ``t`` a per-batch time vector in [0, T].  ``compute_dtype`` and
    ``params`` as in :func:`get_model_fn`."""
    if not (conditional and continuous):
        raise NotImplementedError("only the conditional continuous-time score is ported")
    if not (is_multispeed(sde) or isinstance(sde, VESDE)):
        raise NotImplementedError(f"SDE {type(sde).__name__} is not ported")
    model_fn = get_model_fn(model, train=train, compute_dtype=compute_dtype, params=params)
    N = sde["x"].N if is_multispeed(sde) else sde.N

    def score_fn(inputs, t):
        h = model_fn(inputs, t * (N - 1))
        return _divide_by_std_continuous(h, t, sde)

    return score_fn


def get_conditional_score_fn(score_fn: Callable, target_domain: str = "x") -> Callable:
    """Project a dict score onto one domain: ``fn(x, y, t)``."""

    def conditional_score_fn(x, y, t):
        score = score_fn({"x": x, "y": y}, t)
        if isinstance(score, dict):
            return score[target_domain]
        return score

    return conditional_score_fn
