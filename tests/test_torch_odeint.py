"""The port's dopri5 solver (`sampling/odeint.py`) against
`jax.experimental.ode.odeint`, the solver the JAX package's ODE sampler and
likelihood call: a linear system, a stiff-ish scalar and a tuple state
(x[B, H, W, C], logp[B]) as the likelihood ravels it, float32 with rtol =
atol = 1e-5.  The states at every time (the interpolated ones included) at
1e-5 of their scale, the function evaluations counted on both sides (a
`jax.debug.callback` in the JAX function), and the ``mxstep`` cut-off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.ode import odeint as jax_odeint

from conditional_score_diffusion_tpu_torch.sampling.odeint import odeint

torch.set_num_threads(1)

TOL = 1e-5


def counted(fn):
    """``fn`` with a host counter of its calls at run time."""
    calls = [0]

    def wrapped(y, t):
        jax.debug.callback(lambda: calls.__setitem__(0, calls[0] + 1))
        return fn(y, t)

    return wrapped, calls


def hold(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


A = (np.random.RandomState(0).randn(4, 4) * 0.5).astype(np.float32)


def linear_jax(y, t):
    return jnp.asarray(A) @ y


def linear_torch(y, t):
    return torch.from_numpy(A) @ y


def stiff_jax(y, t):
    return -50.0 * (y - jnp.cos(t))


def stiff_torch(y, t):
    return -50.0 * (y - torch.cos(t))


CASES = {
    "linear": (linear_jax, linear_torch, np.random.RandomState(1).randn(4).astype(np.float32)),
    "stiff": (stiff_jax, stiff_torch, np.array([0.0], np.float32)),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("times", [[0.0, 1.0], [0.0, 0.3, 0.7, 1.0]], ids=["endpoint", "interpolated"])
def test_odeint_matches_jax(name, times):
    jfn, tfn, y0 = CASES[name]
    ts = np.asarray(times, np.float32)
    jfn, calls = counted(jfn)
    want = jax_odeint(jfn, jnp.asarray(y0), jnp.asarray(ts), rtol=TOL, atol=TOL)
    got, nfe = odeint(tfn, torch.from_numpy(y0), torch.from_numpy(ts), rtol=TOL, atol=TOL)
    assert got.shape == (len(ts), *y0.shape)
    hold(got, want)
    assert nfe == calls[0] and (nfe - 2) % 6 == 0  # f0, the first-step probe, 6 a step


def test_tuple_state_matches_jax():
    """The likelihood's state: x and one log-density per sample, raveled
    together, so they share the step size and the error ratio."""
    rng = np.random.RandomState(2)
    x0 = rng.randn(2, 4, 4, 3).astype(np.float32)
    rate = rng.uniform(0.5, 2.0, size=(1, 4, 4, 3)).astype(np.float32)
    ts = np.array([0.0, 0.5, 1.0], np.float32)

    def jfn(state, t):
        x, _ = state
        dx = -jnp.asarray(rate) * x * (1.0 + jnp.sin(3.0 * t))
        return dx, jnp.sum(x**2, axis=(1, 2, 3)) * t

    def tfn(state, t):
        x, _ = state
        dx = -torch.from_numpy(rate) * x * (1.0 + torch.sin(3.0 * t))
        return dx, torch.sum(x**2, dim=(1, 2, 3)) * t

    jfn, calls = counted(jfn)
    wx, wl = jax_odeint(jfn, (jnp.asarray(x0), jnp.zeros(2)), jnp.asarray(ts), rtol=TOL, atol=TOL)
    (gx, gl), nfe = odeint(tfn, (torch.from_numpy(x0), torch.zeros(2)), torch.from_numpy(ts), rtol=TOL, atol=TOL)
    assert gx.shape == (3, 2, 4, 4, 3) and gl.shape == (3, 2)
    hold(gx, wx)
    hold(gl, wl)
    assert nfe == calls[0]


def test_mxstep_cuts_the_loop_as_jax_does():
    """Two steps at most per target time: the state is the interpolation of
    the last accepted step, short of the target, on both sides."""
    jfn, calls = counted(stiff_jax)
    y0, ts = np.array([1.0], np.float32), np.array([0.0, 2.0], np.float32)
    want = jax_odeint(jfn, jnp.asarray(y0), jnp.asarray(ts), rtol=TOL, atol=TOL, mxstep=2)
    got, nfe = odeint(stiff_torch, torch.from_numpy(y0), torch.from_numpy(ts), rtol=TOL, atol=TOL, mxstep=2)
    hold(got, want)
    assert nfe == calls[0] == 2 + 6 * 2
    full, _ = odeint(stiff_torch, torch.from_numpy(y0), torch.from_numpy(ts), rtol=TOL, atol=TOL)
    assert abs(full[-1].item() - got[-1].item()) > 1e-3  # the cut changed the answer
