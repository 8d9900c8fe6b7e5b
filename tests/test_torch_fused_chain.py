"""The port's fully fused Neumann chain (`neumann.fused_neumann_chain`, the
route of INDM_FUSED_CHAIN=1) and the training step that runs it, against
the JAX package.

The JAX side runs `fused_neumann_chain_pallas` in interpret mode, through
`fused_chain_inputs`, at the geometry of `test_neumann_pallas.py:_setup`
with width 64 (the kernel needs a width of 33 or more) and that test's
tolerances (rtol 1e-4, atol 1e-5). The port's wrapper takes its plain
version on these CPU tensors; the CUDA kernel is held against the plain
version on the card by `test_torch_cuda.py` and `chip_smoke.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_neumann as tn
import test_torch_train_step as tts
from indm_torch import convert
from indm_torch.flows import resflow as torch_resflow
from indm_torch.ops import neumann
from indm_tpu.flows.resflow import IResBlock, _poisson_rcdf_table
from indm_tpu.ops import neumann_pallas
from test_torch_fused_block import _count_calls
from test_torch_neumann import _nchw, _nhwc
from torch_threads import one_torch_thread  # noqa: F401

OFFSET = 2
TABLE = _poisson_rcdf_table(2.0, OFFSET)
IDIM = 64
CASES = [(True, True), (True, False), (False, True), (False, False)]


def _setup(preact, cond, seed=0):
  return tn._setup(preact, cond, idim=IDIM, seed=seed)


def _port_inputs(block, h):
  with torch.no_grad():
    return neumann.fused_chain_inputs(
        block, None if h is None else torch.from_numpy(h))


@pytest.mark.parametrize("n", [0, 3])
@pytest.mark.parametrize("preact,cond", CASES)
def test_fused_chain_plain_matches_pallas(preact, cond, n):
  """`fused_chain_inputs` against the JAX packing (weights 1e-6), then
  `fused_neumann_chain_plain` against `fused_neumann_chain_pallas
  (interpret=True)`: rtol 1e-4, atol 1e-5
  (`test_neumann_pallas.py:159-191`)."""
  nnet, params, block, x, h, eps = _setup(preact, cond)
  assert nnet.fused_chain_ok() and block.fused_ok()
  hj = None if h is None else jnp.asarray(h)
  fwd_j, biases_j, mats_j, hp_j = neumann_pallas.fused_chain_inputs(
      nnet.convs, params, hj, None)
  (w0, w1), biases, weights_t, hp = _port_inputs(block, h)
  c = x.shape[-1]
  packed = [w0.permute(2, 3, 1, 0).reshape(9 * c, IDIM), w1.T,
            weights_t[0].permute(2, 3, 1, 0).reshape(9 * c, IDIM),
            weights_t[1][:, :, 0, 0].T,
            weights_t[2].permute(1, 2, 3, 0).reshape(IDIM, 9 * c)]
  for a, b in zip(packed + list(biases), [*fwd_j, *mats_j, *biases_j]):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                               rtol=1e-6, atol=1e-7)
  assert (hp is None) == (hp_j is None) == (not cond)
  if cond:
    np.testing.assert_allclose(hp.numpy(), np.asarray(hp_j), rtol=1e-5,
                               atol=1e-6)
  want = neumann_pallas.fused_neumann_chain_pallas(
      jnp.asarray(x), jnp.asarray(eps), fwd_j, biases_j, mats_j, hp_j,
      jnp.asarray(n, jnp.int32), OFFSET, jnp.asarray(TABLE), preact=preact,
      interpret=True)
  neumann.reset_launches()
  acc = neumann.fused_neumann_chain(_nchw(x), _nchw(eps), (w0, w1), biases,
                                    weights_t, hp, n, OFFSET, TABLE, preact)
  assert neumann.fused_launches == 0  # a CPU tensor never reaches the kernel
  np.testing.assert_allclose(_nhwc(acc), np.asarray(want), rtol=1e-4,
                             atol=1e-5)


@pytest.mark.parametrize("n", [0, 3])
@pytest.mark.parametrize("preact,cond", CASES)
def test_fused_chain_plain_matches_kernel7_route(preact, cond, n):
  """The same acc through the route it replaces: the block's `chain_mats`
  and `neumann_chain_plain`, rtol 1e-4, atol 1e-5."""
  _, _, block, x, h, eps = _setup(preact, cond, seed=1)
  ht = None if h is None else torch.from_numpy(h)
  with torch.no_grad():
    acc = neumann.fused_neumann_chain_plain(
        _nchw(x), _nchw(eps), *_port_inputs(block, h), n, OFFSET, TABLE,
        preact)
    weights_t, dacts = block.chain_mats(_nchw(x), ht)
    want = neumann.neumann_chain_plain(_nchw(eps), dacts, weights_t, n,
                                       OFFSET, TABLE)
  np.testing.assert_allclose(acc.numpy(), want.numpy(), rtol=1e-4,
                             atol=1e-5)


def test_fused_chain_refuses_what_the_kernel_does_not_take():
  """The checks the wrapper runs before a launch: channel counts other
  than 3 and 12, other types, non-contiguous inputs, wrong shapes."""
  _, _, block, x, h, eps = _setup(True, True)
  xt, et = _nchw(x), _nchw(eps)
  fwd, biases, weights_t, hp = _port_inputs(block, h)
  neumann._check_fused(xt, et, fwd, biases, weights_t, hp)
  for bad in ((xt.double(), et, fwd, biases, weights_t, hp),
              (xt, et.transpose(2, 3), fwd, biases, weights_t, hp),
              (xt, et, (fwd[0], fwd[1][:, :32]), biases, weights_t, hp),
              (xt, et, fwd, biases, weights_t, hp[:, :32]),
              (xt[:, :4].contiguous(), et[:, :4].contiguous(), fwd, biases,
               weights_t, hp)):
    with pytest.raises(ValueError):
      neumann._check_fused(*bad)


@pytest.mark.parametrize("preact,cond", CASES)
def test_iresblock_fused_chain_matches_jax(preact, cond, monkeypatch):
  """The port's `IResBlock.forward` with the switch on (the fused chain,
  then one VJP with a graph) against the JAX `IResBlock(chain_pallas=True)`
  with INDM_FUSED_CHAIN=1 set before it is traced, the same
  noise=(vareps, n): y to 1e-5/1e-6, logdet to 1e-4/1e-4, the gradients
  of sum(y * r) + sum(logdet * q) with respect to x, the parameters and h
  to 1e-4/1e-5 (`test_torch_neumann.py`). Both sides took the fused
  chain."""
  nnet, params, block, x, h, eps = _setup(preact, cond, seed=2)
  n = 3
  rng = np.random.default_rng(9)
  r = rng.normal(size=x.shape).astype(np.float32)
  q = rng.normal(size=(x.shape[0],)).astype(np.float32)
  monkeypatch.setenv("INDM_FUSED_CHAIN", "1")
  j_calls = _count_calls(monkeypatch, neumann_pallas,
                         "fused_neumann_chain_pallas")
  p_calls = _count_calls(monkeypatch, neumann, "fused_neumann_chain_plain")
  k7_calls = _count_calls(monkeypatch, neumann, "neumann_chain")
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
  assert j_calls

  xt = _nchw(x).requires_grad_()
  ht = None if h is None else torch.from_numpy(h).requires_grad_()
  y_t, ld_t = block(xt, ht, _nchw(eps), n, fused_chain=True)
  (y_t * _nchw(r)).sum().add((ld_t * torch.from_numpy(q)).sum()).backward()
  assert (len(p_calls), len(k7_calls)) == (1, 0)

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


@pytest.mark.parametrize("switch,width,want", [
    (None, IDIM, (0, 4)), ("1", IDIM, (4, 0)), ("1", 8, (0, 4))])
def test_fused_chain_routing_follows_the_switch(switch, width, want,
                                                monkeypatch):
  """`ResidualFlow.fwdpass` hands every block the fused chain under
  INDM_FUSED_CHAIN=1 where the net allows it (in_ch < 33 <= width), and
  keeps `chain_mats` and the chain kernel otherwise, as the JAX package
  routes (`resflow.py:582-599`): (fused chain, chain) calls."""
  flow = torch_resflow.ResidualFlow(8, 3, n_blocks=(2, 2),
                                    intermediate_dim=width)
  x = torch.randn(2, 3, 8, 8, generator=torch.Generator().manual_seed(0))
  noise = flow.sample_noise(x.shape, torch.Generator().manual_seed(1),
                            np.random.default_rng(2))
  if switch is None:
    monkeypatch.delenv("INDM_FUSED_CHAIN", raising=False)
  else:
    monkeypatch.setenv("INDM_FUSED_CHAIN", switch)
  fused = _count_calls(monkeypatch, neumann, "fused_neumann_chain")
  chain = _count_calls(monkeypatch, neumann, "neumann_chain")
  _, logpx = flow.fwdpass(x, None, noise)
  assert (len(fused), len(chain)) == want
  assert torch.isfinite(logpx).all()


# ---- the whole joint step on the chain route with INDM_FUSED_CHAIN=1 ----

FUSED_CHAIN_STEP = {"flow.intermediate_dim": IDIM}


@pytest.fixture(scope="module")
def chain_setup():
  """The JAX step at width 64 on the chain route with INDM_FUSED_CHAIN=1
  (read when the step is traced), counting the calls of
  `fused_neumann_chain_pallas` while it is traced."""
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv("INDM_FUSED_CHAIN", "1")
    j_calls = _count_calls(mp, neumann_pallas, "fused_neumann_chain_pallas")
    gen = tts.jax_step_setup(FUSED_CHAIN_STEP)
    s = next(gen)
    s["jax_fused_chain_calls"] = len(j_calls)
    yield s
    next(gen, None)


@pytest.fixture(scope="module")
def chain_port_step(chain_setup):
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv("INDM_FUSED_CHAIN", "1")
    fused = _count_calls(mp, neumann, "fused_neumann_chain_plain")
    chain = _count_calls(mp, neumann, "neumann_chain")
    out = tts.run_port_step(chain_setup)
  return out, (len(fused), len(chain))


def test_fused_chain_step_took_the_fused_chain(chain_setup, chain_port_step):
  """Both sides ran the fused chain: the JAX step traced it for the two
  blocks of scale 0 and the scan body of scale 1; the port ran the plain
  fused chain for each of its four blocks and no kernel-7 chain."""
  assert chain_setup["jax_fused_chain_calls"] == 3
  assert chain_port_step[1] == (4, 0)


def test_fused_chain_step_losses_match(chain_setup, chain_port_step):
  """Per-example losses and their three terms to 1e-4, as
  `test_torch_train_step.py` holds them."""
  _, _, aux = chain_port_step[0]
  for name, want in zip(tts.torch_joint.METRICS, chain_setup["metrics"]):
    np.testing.assert_allclose(aux[name].detach().numpy(), want, rtol=1e-4,
                               atol=1e-4, err_msg=name)


def test_fused_chain_step_gradients_match(chain_setup, chain_port_step):
  """Both nets' gradients before any update: rtol 1e-4, atol 1e-5."""
  n = 0
  for name, p, want in tts._grad_pairs(chain_setup, chain_port_step[0]):
    assert p.grad is not None, name
    np.testing.assert_allclose(p.grad.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5, err_msg=name)
    n += 1
  assert n > 100
