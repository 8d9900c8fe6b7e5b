"""The port's VP SDE and RK45 solver against the JAX package and scipy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indm_torch import ode as torch_ode
from indm_torch import sde as torch_sde
from indm_tpu import ode as jax_ode
from indm_tpu import sde as jax_sde
from torch_threads import one_torch_thread  # noqa: F401

scipy_integrate = pytest.importorskip("scipy.integrate")

# float32 elementwise formulas evaluated by two libraries: a few ulp
RTOL = 1e-6


def _x_t(seed=0):
  rng = np.random.default_rng(seed)
  x = rng.normal(size=(5, 4, 4, 3)).astype(np.float32)
  t = np.array([1e-5, 1e-3, 0.3, 0.7, 1.0], np.float32)
  return x, t


def _nchw(x):
  return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(x):
  return x.permute(0, 2, 3, 1).numpy()


def test_vpsde_methods_match():
  x, t = _x_t()
  js = jax_sde.VPSDE(1e-5, 0.1, 20.0, 1000)
  ts = torch_sde.VPSDE(1e-5, 0.1, 20.0, 1000)
  xj, tj = jnp.asarray(x), jnp.asarray(t)
  xt, tt = _nchw(x), torch.from_numpy(t)
  for name in ("sde", "marginal_prob"):
    a_j, b_j = getattr(js, name)(xj, tj)
    a_t, b_t = getattr(ts, name)(xt, tt)
    np.testing.assert_allclose(_nhwc(a_t), np.asarray(a_j), rtol=RTOL,
                               atol=1e-7)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=RTOL,
                               atol=1e-7)
  next_t = np.maximum(t - 1e-3, 0.0).astype(np.float32)
  for nt in (None, next_t):
    f_j, g_j = js.discretize(xj, tj, None if nt is None else jnp.asarray(nt))
    f_t, g_t = ts.discretize(xt, tt, None if nt is None
                             else torch.from_numpy(nt))
    np.testing.assert_allclose(_nhwc(f_t), np.asarray(f_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-5)


def test_prior_sampling_takes_injected_noise():
  ts = torch_sde.VPSDE()
  noise = torch.randn(2, 3, 4, 4, generator=torch.Generator().manual_seed(0))
  z = ts.prior_sampling(noise.shape, device="cpu", noise=noise)
  assert torch.equal(z, noise)
  g1 = torch.Generator().manual_seed(5)
  g2 = torch.Generator().manual_seed(5)
  assert torch.equal(ts.prior_sampling((2, 3), g1, "cpu"),
                     ts.prior_sampling((2, 3), g2, "cpu"))


def test_reverse_drift_and_denoise_discretization_match():
  """Probability-flow drift and the reverse-diffusion step at next_t = 0
  (the denoise step) with the same toy score."""
  x, t = _x_t(1)
  js = jax_sde.VPSDE()
  ts = torch_sde.VPSDE()
  j_score = lambda x, t: -x * (1.0 + t[:, None, None, None])
  t_score = lambda x, t: -x * (1.0 + t[:, None, None, None])
  xj, tj = jnp.asarray(x), jnp.asarray(t)
  xt, tt = _nchw(x), torch.from_numpy(t)
  for pf in (True, False):
    d_j = js.reverse(j_score, probability_flow=pf).sde(xj, tj)[0]
    d_t = ts.reverse(t_score, probability_flow=pf).sde(xt, tt)[0]
    np.testing.assert_allclose(_nhwc(d_t), np.asarray(d_j), rtol=1e-5,
                               atol=1e-6)
  zeros = np.zeros_like(t)
  f_j, g_j = js.reverse(j_score).discretize(xj, tj, jnp.asarray(zeros))
  f_t, g_t = ts.reverse(t_score).discretize(xt, tt, torch.from_numpy(zeros))
  np.testing.assert_allclose(_nhwc(f_t), np.asarray(f_j), rtol=1e-5,
                             atol=1e-6)
  np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-5)


def test_rk45_exponential_decay():
  y, nfe = torch_ode.solve_rk45(lambda t, y: -y, 0.0, 2.0, torch.ones(4))
  np.testing.assert_allclose(y.numpy(), np.exp(-2.0), rtol=1e-4)
  assert nfe > 6
  y, _ = torch_ode.solve_rk45(lambda t, y: -y, 1.0, 0.0, torch.ones(3))
  np.testing.assert_allclose(y.numpy(), np.e, rtol=1e-4)


def test_rk45_matches_jax_and_scipy():
  """The nonlinear case of tests/test_ode.py: the same trajectory and the
  same count of function evaluations as the JAX solver (both float32 with
  the same controller), and scipy's answer within that test's 2e-4."""

  def f_np(t, y):
    return np.array([y[1], -np.sin(y[0]) - 0.1 * y[1]])

  def f_jnp(t, y):
    return jnp.stack([y[1], -jnp.sin(y[0]) - 0.1 * y[1]])

  def f_torch(t, y):
    return torch.stack([y[1], -torch.sin(y[0]) - 0.1 * y[1]])

  y0 = np.array([1.5, 0.0], np.float32)
  sol = scipy_integrate.solve_ivp(f_np, (0.0, 10.0), y0, rtol=1e-5,
                                  atol=1e-5, method="RK45")
  y_jx, nfe_jx = jax.jit(lambda y0: jax_ode.solve_rk45(
      f_jnp, 0.0, 10.0, y0, rtol=1e-5, atol=1e-5))(jnp.asarray(y0))
  y_pt, nfe_pt = torch_ode.solve_rk45(f_torch, 0.0, 10.0,
                                      torch.from_numpy(y0), rtol=1e-5,
                                      atol=1e-5)
  assert nfe_pt == int(nfe_jx)
  np.testing.assert_allclose(y_pt.numpy(), np.asarray(y_jx), atol=1e-5)
  np.testing.assert_allclose(y_pt.numpy(), sol.y[:, -1], atol=2e-4)
  assert abs(nfe_pt - sol.nfev) / sol.nfev < 0.4
