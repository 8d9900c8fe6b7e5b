"""The port's Neumann chain and its iResBlock training forward against the
JAX package.

`neumann_chain` takes its plain version on CPU tensors; the JAX side runs
`neumann_chain_ref` and `neumann_chain_pallas` in interpret mode, as
`test_neumann_pallas.py` runs them, at that test's geometry and
tolerances. The CUDA kernel itself is compared with the plain version on
the card by `test_torch_cuda.py` and `chip_smoke.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indm_torch import convert
from indm_torch.flows import resflow as torch_resflow
from indm_torch.ops import neumann
from indm_tpu.flows.resflow import (IResBlock, LipschitzNNet,
                                    _poisson_rcdf_table)
from indm_tpu.ops import neumann_pallas

OFFSET = 2
CASES = [(True, True), (True, False), (False, True)]  # (preact, cond)


def _nchw(a):
  return torch.from_numpy(np.ascontiguousarray(
      np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
  return t.detach().permute(0, 2, 3, 1).numpy()


def _setup(preact, cond, in_ch=12, idim=32, hw=8, b=4, seed=0):
  """The JAX net of `test_neumann_pallas.py:_setup`, its port twin with the
  same weights, and inputs from numpy."""
  nnet = LipschitzNNet(in_ch, idim, kernels=(3, 1, 3), coeff=0.98,
                       act="sin", cond_dim=16 if cond else None,
                       preact=preact)
  params = jax.tree_util.tree_map(np.asarray,
                                  nnet.init(jax.random.PRNGKey(seed)))
  block = torch_resflow.IResBlock(in_ch, idim, cond_dim=16 if cond else None,
                                  preact=preact)
  block.load_state_dict(convert._iresblock(block, {"nnet": params}),
                        strict=True)
  rng = np.random.default_rng(seed + 1)
  x = rng.normal(size=(b, hw, hw, in_ch)).astype(np.float32)
  h = rng.normal(size=(b, 16)).astype(np.float32) if cond else None
  eps = rng.normal(size=x.shape).astype(np.float32)
  return nnet, params, block, x, h, eps


@pytest.mark.parametrize("n", [0, 2, 5])
@pytest.mark.parametrize("preact,cond", CASES)
def test_chain_plain_matches_ref_and_pallas(preact, cond, n):
  """The port's `chain_mats` against the JAX net's, then
  `neumann_chain_plain` on them against `neumann_chain_ref` and
  `neumann_chain_pallas(interpret=True)`: rtol 1e-4, atol 1e-5."""
  nnet, params, block, x, h, eps = _setup(preact, cond)
  hj = None if h is None else jnp.asarray(h)
  weights_t, dacts = nnet.chain_mats(params, jnp.asarray(x), h=hj)
  with torch.no_grad():
    wt_port, d_port = block.chain_mats(
        _nchw(x), None if h is None else torch.from_numpy(h))
  assert len(d_port) == len(dacts) == (3 if preact else 2)
  for a, b in zip(d_port, dacts):
    np.testing.assert_allclose(_nhwc(a), np.asarray(b), rtol=1e-5, atol=1e-5)
  for a, b in zip(wt_port, weights_t):  # [O, I, kh, kw] vs HWIO
    np.testing.assert_allclose(a.numpy().transpose(2, 3, 1, 0),
                               np.asarray(b), rtol=1e-6, atol=1e-7)

  table = _poisson_rcdf_table(2.0, OFFSET)
  np.testing.assert_array_equal(torch_resflow.RCDF_TRAIN, table)
  n_j = jnp.asarray(n, jnp.int32)
  acc_ref = neumann_pallas.neumann_chain_ref(
      jnp.asarray(eps), dacts, weights_t, n_j, OFFSET, jnp.asarray(table))
  acc_pl = neumann_pallas.neumann_chain_pallas(
      jnp.asarray(eps), dacts, weights_t, n_j, OFFSET, jnp.asarray(table),
      preact=preact, interpret=True)
  neumann.reset_launches()
  acc = neumann.neumann_chain(_nchw(eps), d_port, wt_port, n, OFFSET, table)
  assert neumann.launches == 0  # a CPU tensor never reaches the kernel
  for want in (acc_ref, acc_pl):
    np.testing.assert_allclose(_nhwc(acc), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_chain_coeffs_match_the_kernel_table():
  """(-1)^k coeff(k), the index clamped to the table as the TPU kernel
  clamps it."""
  table = _poisson_rcdf_table(2.0, OFFSET)
  c = neumann.chain_coeffs(3, OFFSET, table)
  want = [(-1) ** k / table[k] for k in range(1, 6)]
  np.testing.assert_allclose(c, want, rtol=1e-7)
  assert len(neumann.chain_coeffs(200, OFFSET, table)) == 202
  assert neumann.chain_coeffs(200, OFFSET, table)[-1] == np.float32(
      1.0) / table[-1]


@pytest.mark.parametrize("preact,cond", CASES)
def test_iresblock_train_forward_and_grads_match(preact, cond):
  """The port's `IResBlock.forward` (chain, then one VJP with a graph)
  against the JAX `IResBlock(chain_pallas=True)` with the same
  `noise=(vareps, n)`: y to 1e-5/1e-6, logdet to 1e-4/1e-4, and the
  gradients of sum(y * r) + sum(logdet * q) with respect to x, the
  parameters and h to 1e-4/1e-5 (`test_neumann_pallas.py:101-137`)."""
  nnet, params, block, x, h, eps = _setup(preact, cond)
  n = 3
  rng = np.random.default_rng(9)
  r = rng.normal(size=x.shape).astype(np.float32)
  q = rng.normal(size=(x.shape[0],)).astype(np.float32)
  jblock = IResBlock(nnet, n_dist="poisson", chain_pallas=True)

  def loss(p, xx, hh):
    y, lp = jblock.forward({"nnet": p}, xx, jnp.zeros((xx.shape[0],)), h=hh,
                           train=True,
                           noise=(jnp.asarray(eps), jnp.asarray(n, jnp.int32)))
    return jnp.sum(y * r) + jnp.sum(-lp * q), (y, -lp)

  hj = None if h is None else jnp.asarray(h)
  (_, (y_j, ld_j)), (gp, gx, gh) = jax.value_and_grad(
      loss, argnums=(0, 1, 2), has_aux=True)(
          jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x), hj)

  xt = _nchw(x).requires_grad_()
  ht = None if h is None else torch.from_numpy(h).requires_grad_()
  y_t, ld_t = block(xt, ht, _nchw(eps), n)
  (y_t * _nchw(r)).sum().add((ld_t * torch.from_numpy(q)).sum()).backward()

  np.testing.assert_allclose(_nhwc(y_t), np.asarray(y_j), rtol=1e-5,
                             atol=1e-6)
  np.testing.assert_allclose(ld_t.detach().numpy(), np.asarray(ld_j),
                             rtol=1e-4, atol=1e-4)
  np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx), rtol=1e-4,
                             atol=1e-5)
  if cond:
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(gh), rtol=1e-4,
                               atol=1e-5)
  grads = convert._iresblock(block, {"nnet": jax.tree_util.tree_map(
      np.asarray, gp)})
  named = dict(block.named_parameters())
  assert set(grads) == set(named)
  for name, want in grads.items():
    np.testing.assert_allclose(named[name].grad.numpy(), want.numpy(),
                               rtol=1e-4, atol=1e-5, err_msg=name)
