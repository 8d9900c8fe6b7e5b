"""The port's fused iResBlock pair (`indm_torch.ops.fused_block`) and the
training step that runs it, against the JAX package.

The JAX side runs as `test_fused_block.py` runs it: `fused_block_apply`
with cfg (offset 2, preact, "float32", interpret) and
`fused_block_reference`, at that test's geometry (width 64, 8x8, batch 4)
and tolerances (y 1e-5, logdet 1e-4, gradients 2e-4), for C = 3 and 12.
The port's wrappers take their plain versions on these CPU tensors; the
CUDA kernels are held against the plain versions on the card by
`test_torch_cuda.py` and `chip_smoke.py`. Weights of variance 1/fan_in
keep every term of the chain of order one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train_step as tts
from indm_torch import convert
from indm_torch.flows import resflow as torch_resflow
from indm_torch.ops import fused_block as pfb
from indm_torch.ops import fused_stack as pfs
from indm_torch.ops import neumann
from indm_tpu.flows.resflow import (IResBlock, LipschitzNNet,
                                    _poisson_rcdf_table)
from indm_tpu.ops import fused_block as jfb
from test_torch_neumann import _nchw, _nhwc
from torch_threads import one_torch_thread  # noqa: F401

OFFSET = 2
TABLE = _poisson_rcdf_table(2.0, OFFSET)
IDIM, HW, B, COND = 64, 8, 4, 16
CASES = [(True, True), (True, False), (False, True)]  # (preact, cond)


def _oihw(w):
  return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _inputs(c, cond, seed=0):
  """NHWC x and vareps, HWIO weights of variance 1/fan_in, biases and hp,
  from numpy."""
  rng = np.random.default_rng(seed)

  def w(*shape):
    return (rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))).astype(
        np.float32)

  ws = (w(3, 3, c, IDIM), w(1, 1, IDIM, IDIM), w(3, 3, IDIM, c))
  bs = tuple((0.1 * rng.normal(size=n)).astype(np.float32)
             for n in (IDIM, IDIM, c))
  hp = (0.3 * rng.normal(size=(B, IDIM))).astype(np.float32) if cond else None
  x = rng.normal(size=(B, HW, HW, c)).astype(np.float32)
  eps = rng.normal(size=x.shape).astype(np.float32)
  return x, ws, bs, hp, eps


def _port_args(x, ws, bs, hp, eps):
  return (_nchw(x), *map(_oihw, ws), *map(torch.from_numpy, bs),
          None if hp is None else torch.from_numpy(hp), _nchw(eps))


def _jax_apply(preact, x, ws, bs, hp, eps, n):
  cfg = (OFFSET, preact, "float32", True)   # interpret mode, float32
  return jfb.fused_block_apply(
      cfg, jnp.asarray(x), *map(jnp.asarray, ws), *map(jnp.asarray, bs),
      None if hp is None else jnp.asarray(hp), jnp.asarray(eps),
      jnp.asarray(n, jnp.int32), jnp.asarray(TABLE))


@pytest.mark.parametrize("c", [3, 12])
@pytest.mark.parametrize("n", [0, 3])
@pytest.mark.parametrize("preact,cond", CASES)
def test_plain_forward_matches_jax(preact, cond, n, c):
  """(y, logdet) of `fused_block_fwd_plain` against `fused_block_apply`
  (interpret) and `fused_block_reference`: y 1e-5, logdet 1e-4. u against
  the port's own chain, `neumann_chain_plain` on the block's diagonals,
  plus vareps: 1e-5."""
  x, ws, bs, hp, eps = _inputs(c, cond)
  args = _port_args(x, ws, bs, hp, eps)
  pfb.reset_launches()
  y, ld, u = pfb.fused_block_fwd(*args, n, OFFSET, TABLE, preact)
  assert pfb.fwd_launches == 0   # a CPU tensor never reaches the kernel
  y_k, ld_k = _jax_apply(preact, x, ws, bs, hp, eps, n)
  y_r, ld_r = jfb.fused_block_reference(
      jnp.asarray(x), tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)),
      None if hp is None else jnp.asarray(hp), jnp.asarray(eps), n, TABLE,
      OFFSET, preact)
  for y_j, ld_j in ((y_k, ld_k), (y_r, ld_r)):
    np.testing.assert_allclose(_nhwc(y), np.asarray(y_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_j), rtol=1e-4,
                               atol=1e-4)

  xt, w0, w1, w2, b0, b1, _, hpt, et = args
  s0 = torch_resflow.sin_act(xt) if preact else xt
  z1 = torch.nn.functional.conv2d(s0, w0, b0, padding=1)
  s1 = torch_resflow.sin_act(z1) + (0 if hpt is None else hpt[:, :, None,
                                                              None])
  z2 = torch.nn.functional.conv2d(s1, w1, b1)
  dacts = [torch.cos(2 * np.pi * z2), torch.cos(2 * np.pi * z1)]
  if preact:
    dacts.append(torch.cos(2 * np.pi * xt))
  wt = [neumann.transpose_conv_weight(w).contiguous() for w in (w2, w1, w0)]
  want = et + neumann.neumann_chain_plain(et, dacts, wt, n, OFFSET, TABLE)
  np.testing.assert_allclose(u.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def _loss_cotangents(y):
  """(ybar, lbar) of 0.1 * sum(y cos y) + 0.7 * sum(logdet)."""
  return 0.1 * (torch.cos(y) - y * torch.sin(y)), torch.full((B,), 0.7)


@pytest.mark.parametrize("c", [3, 12])
@pytest.mark.parametrize("preact,cond", CASES)
def test_plain_backward_matches_jax_grad(preact, cond, c):
  """The eight gradients of `fused_block_bwd_plain` for
  0.1 * sum(y cos y) + 0.7 * sum(logdet) against `jax.grad` of the fused
  JAX apply (interpret): 2e-4 (`test_fused_block.py:99`)."""
  n = 2
  x, ws, bs, hp, eps = _inputs(c, cond, seed=1)
  args = _port_args(x, ws, bs, hp, eps)
  xt, w0, w1, w2, b0, b1, b2, hpt, et = args
  y, _, u = pfb.fused_block_fwd_plain(*args, n, OFFSET, TABLE, preact)
  ybar, lbar = _loss_cotangents(y)
  got = pfb.fused_block_bwd_plain(xt, et, u, ybar, lbar, w0, w1, w2, b0, b1,
                                  hpt, preact)
  assert (got[-1] is None) == (hp is None)

  def loss(xx, wws, bbs, hh):
    yy, ld = jfb.fused_block_apply(
        (OFFSET, preact, "float32", True), xx, *wws, *bbs, hh,
        jnp.asarray(eps), jnp.asarray(n, jnp.int32), jnp.asarray(TABLE))
    return jnp.sum(yy * jnp.cos(yy)) * 0.1 + jnp.sum(ld * 0.7)

  gx, gw, gb, gh = jax.grad(loss, argnums=(0, 1, 2, 3))(
      jnp.asarray(x), tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)),
      None if hp is None else jnp.asarray(hp))
  want = [np.asarray(gx).transpose(0, 3, 1, 2)]
  want += [np.asarray(g).transpose(3, 2, 0, 1) for g in gw]
  want += [np.asarray(g) for g in gb]
  names = ["xbar", "w0g", "w1g", "w2g", "b0g", "b1g", "b2g", "hbar"]
  if hp is not None:
    want.append(np.asarray(gh))
  for name, a, b in zip(names, got, want):
    np.testing.assert_allclose(a.numpy(), b, rtol=2e-4, atol=2e-4,
                               err_msg=name)


def _block_pair(preact, cond, c=3, seed=0):
  """The JAX net and the port block with its weights."""
  nnet = LipschitzNNet(c, IDIM, kernels=(3, 1, 3), coeff=0.98, act="sin",
                       cond_dim=COND if cond else None, preact=preact)
  params = jax.tree_util.tree_map(np.asarray,
                                  nnet.init(jax.random.PRNGKey(seed)))
  block = torch_resflow.IResBlock(c, IDIM, cond_dim=COND if cond else None,
                                  preact=preact, fused_block=True)
  block.load_state_dict(convert._iresblock(block, {"nnet": params}),
                        strict=True)
  return nnet, params, block


@pytest.mark.parametrize("preact,cond", CASES)
def test_analytic_backward_matches_double_backward(preact, cond):
  """`FusedBlockFn` (the plain analytic backward on the CPU) against the
  port's autograd route `_BlockLogdet` (the VJP's double backward), on the
  same (x, h, u, vareps): the gradients of x, h and every block parameter
  through `normalized_weight`, 1e-4 / 1e-5."""
  _, _, block = _block_pair(preact, cond)
  rng = np.random.default_rng(5)
  x = torch.from_numpy(rng.normal(size=(B, 3, HW, HW)).astype(np.float32))
  eps = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
  h = (torch.from_numpy(rng.normal(size=(B, COND)).astype(np.float32))
       if cond else None)
  convs = block.convs()
  n = 2
  with torch.no_grad():   # the u that FusedBlockFn's forward computes
    hp = None if h is None else convs[1].h_net.net(h)
    _, _, u = pfb.fused_block_fwd_plain(
        x, *(cv.normalized_weight() for cv in convs),
        *(cv.bias for cv in convs), hp, eps, n, OFFSET, TABLE, preact)
  r = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
  q = torch.from_numpy(rng.normal(size=(B,)).astype(np.float32))

  def grads(fused):
    block.zero_grad()
    xx = x.clone().requires_grad_()
    hh = None if h is None else h.clone().requires_grad_()
    if fused:
      hp = None if hh is None else convs[1].h_net.net(hh)
      y, ld = pfb.FusedBlockFn.apply(
          xx, *(cv.normalized_weight() for cv in convs),
          *(cv.bias for cv in convs), hp, eps, n, OFFSET, TABLE, preact)
    else:
      y, ld = torch_resflow._BlockLogdet.apply(block, xx, hh, u, eps,
                                               *block.parameters())
    ((y * r).sum() + (ld * q).sum()).backward()
    out = {"x": xx.grad.clone()}
    if hh is not None:
      out["h"] = hh.grad.clone()
    out.update({k: p.grad.clone() for k, p in block.named_parameters()})
    return out

  want, got = grads(False), grads(True)
  assert set(got) == set(want)
  for k in want:
    np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4,
                               atol=1e-5, err_msg=k)


def _count_calls(monkeypatch, module, name):
  calls = []
  fn = getattr(module, name)

  def spy(*args, **kwargs):
    calls.append(name)
    return fn(*args, **kwargs)

  monkeypatch.setattr(module, name, spy)
  return calls


@pytest.mark.parametrize("preact,cond", CASES)
def test_iresblock_fused_matches_jax(preact, cond, monkeypatch):
  """`IResBlock(fused_block=True)` against the JAX
  `IResBlock(nnet, fused_block=True)` with the same noise=(vareps, n): y
  1e-5, logdet 1e-4, the gradients of x, h and every parameter through
  `normalized_weight` 2e-4 (`test_fused_block.py:103-133`). Both sides
  went through the fused route."""
  nnet, params, block = _block_pair(preact, cond, seed=2)
  n = 3
  rng = np.random.default_rng(7)
  x = rng.normal(size=(B, HW, HW, 3)).astype(np.float32)
  h = rng.normal(size=(B, COND)).astype(np.float32) if cond else None
  eps = rng.normal(size=x.shape).astype(np.float32)
  j_calls = _count_calls(monkeypatch, jfb, "fused_block_apply")
  p_fwd = _count_calls(monkeypatch, pfb, "fused_block_fwd_plain")
  p_bwd = _count_calls(monkeypatch, pfb, "fused_block_bwd_plain")
  jblock = IResBlock(nnet, n_dist="poisson", fused_block=True)

  def loss(p, xx, hh):
    y, lp = jblock.forward({"nnet": p}, xx, jnp.zeros((B,)), h=hh,
                           train=True,
                           noise=(jnp.asarray(eps), jnp.asarray(n, jnp.int32)))
    return jnp.mean(lp) + 0.05 * jnp.sum(y ** 2), (y, -lp)

  hj = None if h is None else jnp.asarray(h)
  (_, (y_j, ld_j)), (gp, gx, gh) = jax.value_and_grad(
      loss, argnums=(0, 1, 2), has_aux=True)(
          jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x), hj)
  assert j_calls

  xt = _nchw(x).requires_grad_()
  ht = None if h is None else torch.from_numpy(h).requires_grad_()
  y_t, ld_t = block(xt, ht, _nchw(eps), n)
  ((-ld_t).mean() + 0.05 * (y_t ** 2).sum()).backward()
  assert (len(p_fwd), len(p_bwd)) == (1, 1)

  np.testing.assert_allclose(_nhwc(y_t), np.asarray(y_j), rtol=1e-5,
                             atol=1e-5)
  np.testing.assert_allclose(ld_t.detach().numpy(), np.asarray(ld_j),
                             rtol=1e-4, atol=1e-4)
  np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx), rtol=2e-4,
                             atol=2e-4)
  if cond:
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(gh), rtol=2e-4,
                               atol=2e-4)
  grads = convert._iresblock(block, {"nnet": jax.tree_util.tree_map(
      np.asarray, gp)})
  named = dict(block.named_parameters())
  assert set(grads) == set(named)
  for name, want in grads.items():
    np.testing.assert_allclose(named[name].grad.numpy(), want.numpy(),
                               rtol=2e-4, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("switch", [None, "1", "0"])
def test_fused_routing_follows_the_stack_switch(switch, monkeypatch):
  """With `fused_block` on, the blocks that the JAX package runs in a
  scanned stack (scale 1 of "2-2") go through the stack kernels in one
  call unless INDM_FUSED_STACK=0, which runs every block through the fused
  pair; the two blocks of scale 0 take the fused pair either way."""
  flow = torch_resflow.ResidualFlow(8, 3, n_blocks=(2, 2),
                                    intermediate_dim=IDIM, fused_block=True)
  assert [b.in_stack for b in flow.blocks()] == [False, False, True, True]
  assert [b.preact for b in flow.blocks()] == [False, True, True, True]
  x = torch.randn(2, 3, 8, 8, generator=torch.Generator().manual_seed(0))
  noise = flow.sample_noise(x.shape, torch.Generator().manual_seed(1),
                            np.random.default_rng(2))
  if switch is None:
    monkeypatch.delenv("INDM_FUSED_STACK", raising=False)
  else:
    monkeypatch.setenv("INDM_FUSED_STACK", switch)
  stack = _count_calls(monkeypatch, pfs, "fused_stack_fwd")
  pair = _count_calls(monkeypatch, pfb, "fused_block_fwd")
  _, logpx = flow.fwdpass(x, None, noise)
  assert (len(stack), len(pair)) == ((0, 4) if switch == "0" else (1, 2))
  assert torch.isfinite(logpx).all()


# ---- the whole joint step with flow.fused_block=True ----

FUSED_STEP = {"flow.intermediate_dim": IDIM, "flow.fused_block": True}


@pytest.fixture(scope="module")
def fused_setup():
  """The JAX step at width 64 with `flow.fused_block=True` under
  INDM_FUSED_STACK=0 (read when the step is traced), counting the calls of
  `fused_block_apply` while it is traced."""
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv("INDM_FUSED_STACK", "0")
    j_calls = _count_calls(mp, jfb, "fused_block_apply")
    gen = tts.jax_step_setup(FUSED_STEP)
    s = next(gen)
    s["jax_fused_calls"] = len(j_calls)
    yield s
    next(gen, None)


@pytest.fixture(scope="module")
def fused_port_step(fused_setup):
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv("INDM_FUSED_STACK", "0")
    p_fwd = _count_calls(mp, pfb, "fused_block_fwd_plain")
    p_bwd = _count_calls(mp, pfb, "fused_block_bwd_plain")
    p_chain = _count_calls(mp, neumann, "neumann_chain")
    out = tts.run_port_step(fused_setup)
  return out, (len(p_fwd), len(p_bwd), len(p_chain))


def test_fused_step_took_the_fused_route(fused_setup, fused_port_step):
  """Both sides ran the fused pair: the JAX step traced
  `fused_block_apply` for the two blocks of scale 0 and the scan body of
  scale 1; the port ran the plain fused forward and backward for each of
  its four blocks and no separate chain."""
  assert fused_setup["jax_fused_calls"] == 3
  assert fused_port_step[1] == (4, 4, 0)


def test_fused_step_losses_match(fused_setup, fused_port_step):
  """Per-example losses and their three terms to 1e-4, as
  `test_torch_train_step.py` holds them."""
  _, _, aux = fused_port_step[0]
  for name, want in zip(tts.torch_joint.METRICS, fused_setup["metrics"]):
    np.testing.assert_allclose(aux[name].detach().numpy(), want, rtol=1e-4,
                               atol=1e-4, err_msg=name)


def test_fused_step_gradients_match(fused_setup, fused_port_step):
  """Both nets' gradients before any update: rtol 1e-4, atol 1e-5."""
  n = 0
  for name, p, want in tts._grad_pairs(fused_setup, fused_port_step[0]):
    assert p.grad is not None, name
    np.testing.assert_allclose(p.grad.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5, err_msg=name)
    n += 1
  assert n > 100


@pytest.mark.parametrize("name,value", [("fused_block", True),
                                        ("logdet_unroll", 4),
                                        ("logdet_bf16", True),
                                        ("mixed_precision", True)])
def test_training_flags(name, value):
  """Every flow flag of the training estimator is taken: a tiny flow built
  with it runs a training forward on the CPU to finite values.
  `flow.fused_block` selects the fused kernels in float32;
  `flow.logdet_unroll` reaches every block as its unroll length; the two
  precision switches give the chain route (`flow.fused_block=False`) the
  bfloat16 compute type, and `flow.mixed_precision` also the bfloat16
  plain net."""
  from indm_torch.configs import get_config
  from indm_torch.flows import flow_model
  cfg = get_config("vp/CIFAR10/indm_nll")
  cfg.data.image_size = 8
  cfg.flow.nblocks, cfg.flow.intermediate_dim = "2-2", 64
  cfg.flow[name] = value
  model = flow_model.FlowModel(cfg, generator=torch.Generator().manual_seed(0))
  blocks = model.resflow.blocks()
  dtype = torch.float32 if name in ("fused_block", "logdet_unroll") \
      else torch.bfloat16
  assert flow_model.flow_compute_dtype(cfg) == dtype
  assert {b.compute_dtype for b in blocks} == {dtype}
  assert {b.fused_block for b in blocks} == {name == "fused_block"}
  assert {b.unroll_terms for b in blocks} == {
      value if name == "logdet_unroll" else 0}
  assert {b.mixed_precision for b in blocks} == {name == "mixed_precision"}
  x = torch.randn(2, 3, 8, 8, generator=torch.Generator().manual_seed(1))
  z, logdet_kl = flow_model.flow_forward(
      cfg, model.train(), x, train=True, generator=torch.Generator(),
      host_rng=np.random.default_rng(2))
  assert z.shape == x.shape
  assert torch.isfinite(z).all() and torch.isfinite(logdet_kl).all()
