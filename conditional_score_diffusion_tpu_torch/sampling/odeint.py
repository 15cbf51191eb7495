"""Adaptive Dormand-Prince (dopri5) integration, a torch copy of the forward
of `jax.experimental.ode.odeint`, which the JAX package's ODE sampler and
likelihood call.

What is copied, piece by piece: the initial step size (Hairer, Norsett and
Wanner, Sec. II.4, with order 4 as JAX passes it), the dopri5 step with
first-same-as-last, the RMS error ratio over every element of the raveled
state, the step-size controller (safety 0.9, ifactor 10, dfactor 0.2,
order 5), the loop that stops on reaching the target time, on ``mxstep``
steps or on a step size that is not positive, and the 4th-order
interpolation that gives the state at each target time.  A rejected step
keeps the state and takes the controller's smaller step, as JAX's
``jnp.where`` does.

The state is a tensor or a tuple of tensors; it is raveled into one vector
(in the tuple's order), so the whole state shares one step size and one
error ratio, as JAX's ``ravel_pytree`` makes it.  Times and step sizes stay
0-d tensors of the state's type on its device; the loop's condition is read
on the host, one sync per step.  JAX's adjoint (the backward) is not copied.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple, Union

import torch

State = Union[torch.Tensor, Tuple[torch.Tensor, ...]]

# the dopri5 Butcher tableau (JAX `runge_kutta_step`)
_ALPHA = (1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0, 0.0)
_BETA = (
    (1 / 5, 0, 0, 0, 0, 0, 0),
    (3 / 40, 9 / 40, 0, 0, 0, 0, 0),
    (44 / 45, -56 / 15, 32 / 9, 0, 0, 0, 0),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0, 0, 0),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656, 0, 0),
    (35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0),
)
_C_SOL = (35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0)
_C_ERROR = (
    35 / 384 - 1951 / 21600, 0, 500 / 1113 - 22642 / 50085, 125 / 192 - 451 / 720,
    -2187 / 6784 - -12231 / 42400, 11 / 84 - 649 / 6300, -1.0 / 60.0,
)
# the midpoint weights of the dense output (JAX `interp_fit_dopri`)
_C_MID = (
    6025192743 / 30085553152 / 2, 0, 51252292925 / 65400821598 / 2, -2691868925 / 45128329728 / 2,
    187940372067 / 1594534317056 / 2, -1776094331 / 19743644256 / 2, 11237099 / 235043384 / 2,
)


def _combine(coeffs: Sequence[float], k: Sequence[torch.Tensor]) -> torch.Tensor:
    """sum_j coeffs[j] * k[j] as XLA's CPU dot computes it: one fused
    multiply-add per stage, in stage order, each rounded once to the stages'
    type (emulated in float64, where the product of two float32 values is
    exact).  The error estimate is a small difference of large terms, and
    its rounding steers the step size; a zero coefficient adds nothing."""
    out = None
    for c, kj in zip(coeffs, k):
        if c != 0:
            c = float(torch.tensor(c, dtype=kj.dtype))  # the coefficient in the stages' type, as JAX casts it
            term = kj.double() * c
            out = (term if out is None else term + out.double()).to(kj.dtype)
    return out


def _ravel(state: State):
    """(flat vector, unravel): a tuple's tensors flattened and concatenated."""
    if torch.is_tensor(state):
        shape = state.shape
        return state.reshape(-1), lambda flat: flat.reshape(shape)
    shapes = [s.shape for s in state]
    sizes = [s.numel() for s in state]

    def unravel(flat):
        return tuple(part.reshape(shape) for part, shape in zip(torch.split(flat, sizes), shapes))

    return torch.cat([s.reshape(-1) for s in state]), unravel


def _flat(out: State) -> torch.Tensor:
    return out.reshape(-1) if torch.is_tensor(out) else torch.cat([o.reshape(-1) for o in out])


def initial_step_size(fun, t0, y0, order, rtol, atol, f0):
    """The first step (JAX `initial_step_size`); calls ``fun`` once."""
    scale = atol + torch.abs(y0) * rtol
    d0 = torch.linalg.vector_norm(y0 / scale)
    d1 = torch.linalg.vector_norm(f0 / scale)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), torch.full_like(d0, 1e-6), 0.01 * d0 / d1)
    y1 = y0 + h0 * f0
    f1 = fun(y1, t0 + h0)
    d2 = torch.linalg.vector_norm((f1 - f0) / scale) / h0
    h1 = torch.where(
        (d1 <= 1e-15) & (d2 <= 1e-15),
        torch.clamp(h0 * 1e-3, min=1e-6),
        (0.01 / torch.maximum(d1, d2)) ** (1.0 / (order + 1.0)),
    )
    return torch.minimum(100.0 * h0, h1)


def runge_kutta_step(fun, y0, f0, t0, dt):
    """One dopri5 step: ``(y1, f1, y1_error, k)``; calls ``fun`` 6 times
    (``f1`` is the last stage, evaluated at ``t0 + dt``)."""
    k = [f0]
    for i in range(1, 7):
        ti = t0 + dt * _ALPHA[i - 1]
        yi = y0 + dt * _combine(_BETA[i - 1], k)
        k.append(fun(yi, ti))
    y1 = dt * _combine(_C_SOL, k) + y0
    y1_error = dt * _combine(_C_ERROR, k)
    return y1, k[-1], y1_error, k


def mean_error_ratio(error_estimate, rtol, atol, y0, y1):
    """RMS over every element of error / (atol + rtol max(|y0|, |y1|))."""
    err_tol = atol + rtol * torch.maximum(torch.abs(y0), torch.abs(y1))
    return torch.sqrt(torch.mean((error_estimate / err_tol) ** 2))


def optimal_step_size(last_step, error_ratio, safety=0.9, ifactor=10.0, dfactor=0.2, order=5.0):
    """The controller's next step (JAX `optimal_step_size`)."""
    dfactor = torch.where(error_ratio < 1, torch.ones_like(error_ratio), torch.full_like(error_ratio, dfactor))
    factor = torch.clamp(torch.maximum(error_ratio ** (-1.0 / order) * safety, dfactor), max=ifactor)
    return torch.where(error_ratio == 0, last_step * ifactor, last_step * factor)


def interp_fit_dopri(y0, y1, k, dt):
    """The coefficients (a, b, c, d, e) of the 4th-order polynomial through
    the step (JAX `interp_fit_dopri` and `fit_4th_order_polynomial`)."""
    y_mid = y0 + dt * _combine(_C_MID, k)
    dy0, dy1 = k[0], k[-1]
    a = -2.0 * dt * dy0 + 2.0 * dt * dy1 - 8.0 * y0 - 8.0 * y1 + 16.0 * y_mid
    b = 5.0 * dt * dy0 - 3.0 * dt * dy1 + 18.0 * y0 + 14.0 * y1 - 32.0 * y_mid
    c = -4.0 * dt * dy0 + dt * dy1 - 11.0 * y0 - 5.0 * y1 + 16.0 * y_mid
    d = dt * dy0
    e = y0
    return torch.stack([a, b, c, d, e])


def _polyval(coeffs, x):
    """Horner's rule as `jnp.polyval` runs it, from a zero start."""
    y = torch.zeros_like(coeffs[0])
    for c in coeffs:
        y = y * x + c
    return y


def odeint(
    func: Callable,
    y0: State,
    t: torch.Tensor,
    rtol: float = 1.4e-8,
    atol: float = 1.4e-8,
    mxstep: float = math.inf,
    hmax: float = math.inf,
):
    """Integrate ``dy/dt = func(y, t)`` from ``t[0]``; returns ``(ys, nfe)``:
    the state at each time of ``t`` (a leading axis of ``len(t)``, as JAX
    stacks it; a tuple state gives a tuple) and the number of ``func``
    calls.  ``t`` is strictly increasing; ``func`` gets the state in
    ``y0``'s structure and a 0-d time tensor."""
    flat0, unravel = _ravel(y0)
    t = t.to(device=flat0.device, dtype=flat0.dtype)
    nfe = 0

    def fun(y, s):
        nonlocal nfe
        nfe += 1
        return _flat(func(unravel(y), s))

    y, t_now = flat0, t[0]
    f = fun(y, t_now)
    dt = torch.clamp(initial_step_size(fun, t_now, y, 4, rtol, atol, f), min=0.0, max=hmax)
    last_t = t_now
    interp_coeff = torch.stack([y] * 5)
    ys = [flat0]
    for target_t in t[1:]:
        i = 0
        while i < mxstep and bool(((t_now < target_t) & (dt > 0)).item()):
            next_y, next_f, next_y_error, k = runge_kutta_step(fun, y, f, t_now, dt)
            next_t = t_now + dt
            error_ratio = mean_error_ratio(next_y_error, rtol, atol, y, next_y)
            new_interp_coeff = interp_fit_dopri(y, next_y, k, dt)
            dt = torch.clamp(optimal_step_size(dt, error_ratio), min=0.0, max=hmax)
            accept = error_ratio <= 1.0
            y = torch.where(accept, next_y, y)
            f = torch.where(accept, next_f, f)
            last_t = torch.where(accept, t_now, last_t)
            t_now = torch.where(accept, next_t, t_now)
            interp_coeff = torch.where(accept, new_interp_coeff, interp_coeff)
            i += 1
        relative_output_time = (target_t - last_t) / (t_now - last_t)
        ys.append(_polyval(interp_coeff, relative_output_time))
    out = torch.stack(ys)
    if torch.is_tensor(y0):
        return out.reshape(len(t), *y0.shape), nfe
    return tuple(torch.stack(parts) for parts in zip(*[unravel(v) for v in out])), nfe
