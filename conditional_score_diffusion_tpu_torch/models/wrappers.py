"""Score-function wrappers: raw network output -> time-dependent score
(JAX `models/wrappers.py`).

* VE family, continuous: a conditional model is fed ``labels = t * (N - 1)``;
  an unconditional one the noise level sigma(t) itself, or log sigma(t)
  for a Fourier time embedding; the output is divided by the marginal std.
* VP family: ``labels = t * (N - 1)``; divided by the marginal std
  (continuous, and always under sub-VP) or by the DDPM
  ``sqrt(1 - alphas_cumprod)`` at the truncated label.
* Discrete VE: labels rounded to integer steps, divided by the sigma ladder
  at them (an unconditional model is fed that sigma).
* Multi-speed dict SDEs: the model consumes and returns dicts; each
  domain's output is divided by that domain's std.
"""

from __future__ import annotations

import copy
from typing import Callable, Mapping, Optional

import torch

from ..sde import VESDE, VPSDE, batch_mul, is_multispeed, subVPSDE


def _map(fn, tree):
    return {k: fn(v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def _requires_grad(inputs) -> bool:
    values = inputs.values() if isinstance(inputs, dict) else (inputs,)
    return any(v.requires_grad for v in values)


def get_model_fn(
    model: torch.nn.Module,
    train: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    params: Optional[Mapping[str, torch.Tensor]] = None,
) -> Callable:
    """``model_fn(inputs, labels)``: the raw network (``inputs`` a tensor or a
    dict of tensors), in train or eval mode, without autograd in eval
    unless an input requires a gradient (the likelihood's divergence
    differentiates the eval network with respect to x).

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
            with torch.set_grad_enabled((train or _requires_grad(inputs)) and torch.is_grad_enabled()):
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


def _divide_by_std_discrete(h, labels, sde):
    if is_multispeed(sde) and isinstance(h, dict):
        return {
            domain: batch_mul(1.0 / sde[domain].discrete_sigmas(labels.device)[labels], h[domain])
            for domain in h
        }
    return batch_mul(1.0 / sde.discrete_sigmas(labels.device)[labels], h)


def _rounded(t, N):
    """Integer labels ``round(t * (N - 1))`` (JAX ``jnp.round``: half to even)."""
    return torch.round(t * (N - 1)).to(torch.int64)


def get_score_fn(
    sde,
    model,
    conditional: bool = False,
    train: bool = False,
    continuous: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    params: Optional[Mapping[str, torch.Tensor]] = None,
) -> Callable:
    """``score_fn(inputs, t)``: ``inputs`` is ``{'x': ..., 'y': ...}`` for a
    conditional (paired) model, else a tensor; ``t`` a per-batch time
    vector in [0, T].  ``compute_dtype`` and ``params`` as in
    :func:`get_model_fn`."""
    model_fn = get_model_fn(model, train=train, compute_dtype=compute_dtype, params=params)
    vp = isinstance(sde, (VPSDE, subVPSDE))

    if conditional:
        if not (is_multispeed(sde) or vp or isinstance(sde, VESDE)):
            raise NotImplementedError(f"SDE {type(sde).__name__} not supported for conditional score.")
        N = sde["x"].N if is_multispeed(sde) else sde.N

        def score_fn(inputs, t):
            if vp:
                labels = t * (N - 1)
                h = model_fn(inputs, labels)
                if continuous:
                    return _divide_by_std_continuous(h, t, sde)
                return batch_mul(1.0 / sde.sqrt_1m_alphas_cumprod(t.device)[labels.to(torch.int64)], h)
            if continuous:
                return _divide_by_std_continuous(model_fn(inputs, t * (N - 1)), t, sde)
            labels = _rounded(t, N)
            return _divide_by_std_discrete(model_fn(inputs, labels), labels, sde)

        return score_fn

    if vp:

        def score_fn(x, t):
            labels = t * (sde.N - 1)
            h = model_fn(x, labels)
            if continuous or isinstance(sde, subVPSDE):
                std = sde.marginal_prob(None, t)[1]
            else:
                std = sde.sqrt_1m_alphas_cumprod(t.device)[labels.to(torch.int64)]
            return batch_mul(1.0 / std, h)

        return score_fn

    if isinstance(sde, VESDE):
        fourier = getattr(model, "embedding_type", "positional") == "fourier"

        def score_fn(x, t):
            if continuous:
                std = sde.marginal_prob(None, t)[1]
                h = model_fn(x, torch.log(std) if fourier else std)
                return batch_mul(1.0 / std, h)
            sigma_labels = sde.discrete_sigmas(t.device)[_rounded(t, sde.N)]
            return batch_mul(1.0 / sigma_labels, model_fn(x, sigma_labels))

        return score_fn

    raise NotImplementedError(f"SDE {type(sde).__name__} not supported.")


def get_conditional_score_fn(score_fn: Callable, target_domain: str = "x") -> Callable:
    """Project a dict score onto one domain: ``fn(x, y, t)``."""

    def conditional_score_fn(x, y, t):
        score = score_fn({"x": x, "y": y}, t)
        if isinstance(score, dict):
            return score[target_domain]
        return score

    return conditional_score_fn
