"""The port's likelihood-weighting SDE functions, score-matching loss and
prior term against the JAX package, with the JAX draws replayed: the
uniforms and normals of `indm_tpu/losses.py:54-59, 152-158` are rebuilt
from their keys and handed to the port. A simple analytic score function
stands in for the network on both sides, so that only the loss is tested.
Tolerances: 1e-6 for the SDE functions (the same float32 formulas), 1e-5
for the losses (float32 sums over 192 values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indm_torch import configs as torch_configs
from indm_torch import losses as torch_losses
from indm_torch import sde as torch_sde
from indm_tpu import configs as jax_configs
from indm_tpu import losses as jax_losses
from indm_tpu import sde as jax_sde

SHAPE = (4, 8, 8, 3)


def _nchw(a):
  return torch.from_numpy(np.ascontiguousarray(
      np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _configs(**training):
  jc = jax_configs.get_config("vp/CIFAR10/indm_nll")
  tc = torch_configs.get_config("vp/CIFAR10/indm_nll")
  for k, v in training.items():
    setattr(jc.training, k, v)
    setattr(tc.training, k, v)
  return jc, tc


def test_sde_likelihood_functions_match():
  jc, tc = _configs()
  js, ts = jax_sde.get_sde(jc), torch_sde.get_sde(tc)
  t = np.array([1e-5, 1e-3, 0.1, 0.5, 1.0], np.float32)
  z = np.random.default_rng(0).normal(size=SHAPE).astype(np.float32)
  for fn in ("integral_beta", "antiderivative"):
    np.testing.assert_allclose(
        getattr(ts, fn)(torch.from_numpy(t)).numpy(),
        np.asarray(getattr(js, fn)(jnp.asarray(t))), rtol=1e-6, atol=1e-6)
  np.testing.assert_allclose(float(ts.normalizing_constant(ts.eps)),
                             float(js.normalizing_constant(js.eps)),
                             rtol=1e-6)
  np.testing.assert_allclose(ts.prior_logp(_nchw(z)).numpy(),
                             np.asarray(js.prior_logp(jnp.asarray(z))),
                             rtol=1e-6)
  assert float(ts.get_t_min(False, device="cpu")) == np.float32(js.eps)
  rng = jax.random.PRNGKey(1)
  u = np.asarray(jax.random.uniform(rng, ()))
  for k in (1.0, 1.2):
    np.testing.assert_allclose(
        float(ts.get_t_min(True, k, u=torch.tensor(u))),
        float(js.get_t_min(rng, True, k)), rtol=1e-6)


@pytest.mark.parametrize("importance_sampling", [True, False])
def test_diffusion_time_matches(importance_sampling):
  jc, tc = _configs()
  js, ts = jax_sde.get_sde(jc), torch_sde.get_sde(tc)
  rng = jax.random.PRNGKey(2)
  t_j, z_j = js.get_diffusion_time(rng, 8, js.eps, importance_sampling)
  u = torch.from_numpy(np.array(jax.random.uniform(rng, (8,))))
  t_t, z_t = ts.get_diffusion_time(8, ts.get_t_min(device="cpu"),
                                   importance_sampling, u=u)
  np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), rtol=1e-6,
                             atol=1e-9)
  np.testing.assert_allclose(float(z_t), float(z_j), rtol=1e-6)


@pytest.mark.parametrize("weighting", ["importance", "likelihood", "plain"])
def test_sde_loss_matches_with_replayed_draws(weighting):
  jc, tc = _configs(importance_sampling=weighting == "importance",
                    likelihood_weighting=weighting != "plain")
  js, ts = jax_sde.get_sde(jc), torch_sde.get_sde(tc)
  batch = np.random.default_rng(3).normal(size=SHAPE).astype(np.float32)
  rng = jax.random.PRNGKey(4)

  def score_j(x, t, rng=None):
    return -x * (1.0 + t[:, None, None, None]) + 0.1 * jnp.sin(x)

  def score_t(x, t, generator=None):
    return -x * (1.0 + t[:, None, None, None]) + 0.1 * torch.sin(x)

  l_j = jax_losses.get_sde_loss_fn(jc, js, True)(score_j, jnp.asarray(batch),
                                                 rng)
  _, rng_t, rng_z, _, _, _ = jax.random.split(rng, 6)
  u_t = torch.from_numpy(np.array(jax.random.uniform(rng_t, (SHAPE[0],))))
  z = _nchw(jax.random.normal(rng_z, SHAPE))
  l_t = torch_losses.get_sde_loss_fn(tc, ts)(score_t, _nchw(batch), u_t=u_t,
                                             z=z)
  np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), rtol=1e-5)


def test_calculate_logp_matches():
  jc, tc = _configs()
  js, ts = jax_sde.get_sde(jc), torch_sde.get_sde(tc)
  batch = np.random.default_rng(5).normal(size=SHAPE).astype(np.float32)
  rng = jax.random.PRNGKey(6)
  lp_j = jax_losses.calculate_logp(js, jnp.asarray(batch), rng)
  lp_t = torch_losses.calculate_logp(ts, _nchw(batch),
                                     z=_nchw(jax.random.normal(rng, SHAPE)))
  np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-5)


def test_loss_draws_come_from_the_generator():
  """Without injected draws the loss is a function of the generator's
  seed alone."""
  _, tc = _configs()
  ts = torch_sde.get_sde(tc)
  loss = torch_losses.get_sde_loss_fn(tc, ts)
  batch = torch.randn(2, 3, 4, 4, generator=torch.Generator().manual_seed(0))
  score = lambda x, t, generator=None: -x

  def run(seed):
    return loss(score, batch, generator=torch.Generator().manual_seed(seed))

  assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))
