"""The bare residual flow (`flow.model=resflow`), `flow.actnorm` and every
`flow.act_fn` in the port, against the JAX package.

`ActNorm2d` both ways with its log-det; the actnorm chain's layout; then
`flow_forward(train=True)` of the unconditioned flow on each route, the
port's kernels taking their plain versions on the CPU and the JAX package
running its Pallas kernels in interpret mode (`flow.logdet_pallas`, as the
JAX package's own tests run them): the chain route (kernel 7) with and
without actnorm, the fused route (kernels 3 and 4 block by block under
actnorm; kernels 5 and 6 on the stack without), INDM_FUSED_CHAIN=1
(kernel 8) and the chain in bfloat16 (`flow.logdet_bf16`); each other
activation on the plain chain that both packages route it to, the fused
switch on too. The weights cross over through `indm_torch.convert`, the
estimator's draws are replayed from the JAX key, and z, the log-det and the
gradients of sum(logdet) + <z, w> are compared: z to 1e-5, the log-det to
1e-4 (a few hundred products summed), the gradients to rtol 1e-4, atol 1e-5
(`tests/test_torch_train_step.py`'s limits); in bfloat16 within 2e-2 of
the largest value (the JAX package's bfloat16 bound, `test_models.py:61`).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train_step as tts
from indm_torch import configs as torch_configs
from indm_torch import convert
from indm_torch.flows import flow_model as torch_fm
from indm_torch.flows import resflow as torch_resflow
from indm_tpu import configs as jax_configs
from indm_tpu.flows import flow_model as jax_fm
from indm_tpu.flows import resflow as jax_resflow
from torch_threads import one_torch_thread  # noqa: F401

NAME = "vp/CIFAR10/indm_nll"
B = 4
BASE = {"data.image_size": 8, "flow.model": "resflow", "flow.nblocks": "2-2",
        "flow.intermediate_dim": 8, "flow.logdet_pallas": True}
WIDE = {"flow.intermediate_dim": 40}   # the fused kernels need 33 or more


def _np(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


def replay_blocks(resflow, rng, shape):
  """Each iResBlock's (vareps NCHW, n) as the JAX `ResidualFlow.forward`
  draws them: per scale, per layer (actnorms and squeezes draw nothing),
  per block of a scanned stack."""
  b, h, w, c = shape
  out = []
  for t, k_scale in zip(resflow.transforms,
                        jax.random.split(rng, resflow.n_scale)):
    for layer, k in zip(t.layers, jax.random.split(k_scale, len(t.layers))):
      if isinstance(layer, jax_resflow.IResBlock):
        keys = [k]
      elif isinstance(layer, jax_resflow.ScannedIResBlocks):
        keys = list(jax.random.split(k, layer.n))
      else:
        if isinstance(layer, jax_resflow.SqueezeLayer):
          h, w, c = h // 2, w // 2, c * 4
        continue
      for kb in keys:
        rng_n, rng_eps = jax.random.split(kb)
        out.append((tts._nchw(jax.random.normal(rng_eps, (b, h, w, c))),
                    int(jax.random.poisson(rng_n, 2.0))))
  return out


def configs(over):
  jc = jax_configs.get_config(NAME)
  tc = torch_configs.get_config(NAME)
  for k, v in {**BASE, **over}.items():
    tts._set(jc, k, v)
    tts._set(tc, k, v)
  return jc, tc


def run_pair(over, env=None, train=True):
  """The JAX and the port's flow_forward on one batch with the same
  weights and draws: {"jax": (z, ld, grads), "port": (z, ld, model)}."""
  env = env or {}
  old = {k: os.environ.get(k) for k in env}
  os.environ.update(env)
  try:
    jc, tc = configs(over)
    fm = jax_fm.create_flow_model(jc)
    params, buffers = fm.init(jax.random.PRNGKey(1))
    # weights off their init, the actnorms' too
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(5),
                                               a.shape), params)
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (B, 8, 8, 3)).astype(np.float32)
    w = rng.normal(size=(B, 8, 8, 3)).astype(np.float32)
    key = jax.random.PRNGKey(6)

    def loss(p):
      z, ld, _ = jax_fm.flow_forward(jc, fm, p, buffers, jnp.asarray(x),
                                     rng=key, train=train)
      return jnp.sum(ld) + jnp.sum(z * w), (z, ld)

    if train:
      (_, (z_j, ld_j)), g_j = jax.jit(jax.value_and_grad(
          loss, has_aux=True))(params)
    else:
      (_, (z_j, ld_j)), g_j = jax.jit(loss)(params), None
    flow = torch_fm.FlowModel(tc)
    flow.load_state_dict(convert.flow_state_dict_from_jax(_np(params), tc),
                         strict=True)
    _, rng_f = jax.random.split(key)
    noise = torch_fm.FlowNoise(None, replay_blocks(fm.resflow, rng_f,
                                                   x.shape))
    with torch.set_grad_enabled(train):
      z_t, ld_t = torch_fm.flow_forward(tc, flow, tts._nchw(x), train=train,
                                        noise=noise)
      if train:
        (ld_t.sum() + (z_t * tts._nchw(w)).sum()).backward()
  finally:
    for k, v in old.items():
      if v is None:
        os.environ.pop(k, None)
      else:
        os.environ[k] = v
  return dict(jc=jc, tc=tc, jax=(np.asarray(z_j), np.asarray(ld_j), g_j),
              port=(z_t, ld_t, flow))


def check_pair(r, bf16=False):
  z_j, ld_j, g_j = r["jax"]
  z_t, ld_t, flow = r["port"]
  if bf16:
    for got, want in ((tts._nhwc(z_t), z_j), (ld_t.detach().numpy(), ld_j)):
      np.testing.assert_allclose(got, want, rtol=0,
                                 atol=2e-2 * np.abs(want).max())
  else:
    np.testing.assert_allclose(tts._nhwc(z_t), z_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ld_t.detach().numpy(), ld_j, rtol=1e-4,
                               atol=1e-4)
  want = convert.flow_state_dict_from_jax(_np(g_j), r["tc"])
  named = dict(flow.named_parameters())
  assert set(named) == set(want)
  for name, p in named.items():
    assert p.grad is not None, name
    if bf16:
      big = float(np.abs(want[name].numpy()).max())
      np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=0,
                                 atol=2e-2 * max(big, 1e-6), err_msg=name)
    else:
      np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                 rtol=1e-4, atol=1e-5, err_msg=name)


def test_actnorm2d_matches_jax_both_ways():
  """y = (x + b) e^w, log-det H W sum(w), and the inverse, to 1e-6."""
  rng = np.random.default_rng(0)
  ls = rng.normal(size=3).astype(np.float32) * 0.3
  bias = rng.normal(size=3).astype(np.float32)
  x = rng.normal(size=(2, 4, 5, 3)).astype(np.float32)
  jan = jax_resflow.ActNorm2d(3)
  p = {"log_scale": jnp.asarray(ls), "bias": jnp.asarray(bias)}
  y_j, lp_j = jan.forward(p, jnp.asarray(x), jnp.zeros(2))
  xr_j, lp2_j = jan.inverse(p, y_j, jnp.zeros(2))
  an = torch_resflow.ActNorm2d(3)
  an.load_state_dict({"weight": torch.from_numpy(ls),
                      "bias": torch.from_numpy(bias)})
  xt = tts._nchw(x)
  y_t = an(xt)
  np.testing.assert_allclose(tts._nhwc(y_t), np.asarray(y_j), rtol=1e-6,
                             atol=1e-6)
  np.testing.assert_allclose(-an.logdet(xt).detach().numpy(),
                             np.asarray(lp_j), rtol=1e-6)
  np.testing.assert_allclose(tts._nhwc(an.inverse(y_t)), np.asarray(xr_j),
                             rtol=1e-6, atol=1e-6)
  np.testing.assert_allclose(an.logdet(y_t).detach().numpy(),
                             np.asarray(lp2_j), rtol=1e-6)
  np.testing.assert_allclose(tts._nhwc(an.inverse(y_t)), x, atol=1e-5)


def test_actnorm_chain_layout_matches_jax():
  """An actnorm after every block, nothing stacked (`resflow.py:990-996`),
  the blocks pre-activated but the first, as the JAX layers are."""
  jc, tc = configs({"flow.actnorm": True, "flow.nblocks": "3-2"})
  fm = jax_fm.create_flow_model(jc)
  flow = torch_fm.FlowModel(tc, device="meta")
  assert flow.discriminator is None and flow.gen_module is None
  for t_j, t_t in zip(fm.resflow.transforms, flow.resflow.transforms):
    kinds_j = [type(l).__name__ for l in t_j.layers]
    kinds_t = [type(l).__name__ for l in t_t.chain]
    assert kinds_t == kinds_j
    blocks_j = [l for l in t_j.layers
                if isinstance(l, jax_resflow.IResBlock)]
    blocks_t = [l for l in t_t.chain
                if isinstance(l, torch_resflow.IResBlock)]
    assert [b.nnet.preact for b in blocks_j] == [b.preact for b in blocks_t]
    assert not any(b.in_stack for b in blocks_t)
  keys = list(flow.state_dict())
  assert keys[0].startswith("transforms.0.chain.0.nnet.")
  assert "transforms.0.chain.1.weight" in keys


ROUTES = {
    "chain_actnorm": ({"flow.actnorm": True}, {}),
    "chain": ({}, {}),
    "fused_actnorm": ({**WIDE, "flow.actnorm": True,
                       "flow.fused_block": True}, {}),
    "fused_stack": ({**WIDE, "flow.nblocks": "3-3",
                     "flow.fused_block": True}, {}),
    "fused_chain_actnorm": ({**WIDE, "flow.actnorm": True},
                            {"INDM_FUSED_CHAIN": "1"}),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_bare_resflow_routes_match_jax(route, monkeypatch):
  """The unconditioned flow on each route: the port's wrappers are called
  with no h-projection, and the fused route takes the pair on every block
  under actnorm and the stack without it."""
  over, env = ROUTES[route]
  from indm_torch.ops import fused_block as pfb
  from indm_torch.ops import fused_stack as pfs
  calls = {"pair": 0, "stack": 0}
  real_pair, real_stack = pfb.FusedBlockFn.apply, pfs.FusedStackFn.apply

  def pair(*a):
    calls["pair"] += 1
    assert a[7] is None    # no h-projection
    return real_pair(*a)

  def stack(*a):
    calls["stack"] += 1
    assert a[7] is None
    return real_stack(*a)

  monkeypatch.setattr(pfb.FusedBlockFn, "apply", pair)
  monkeypatch.setattr(pfs.FusedStackFn, "apply", stack)
  r = run_pair(over, env)
  check_pair(r)
  if route == "fused_actnorm":
    assert calls == {"pair": 4, "stack": 0}
  elif route == "fused_stack":
    assert calls == {"pair": 1, "stack": 2}
  else:
    assert calls == {"pair": 0, "stack": 0}


def test_bare_resflow_bf16_chain_matches_jax():
  """The chain route in bfloat16 (kernel 7's bfloat16 mode) with actnorm."""
  check_pair(run_pair({"flow.actnorm": True, "flow.logdet_bf16": True}),
             bf16=True)


@pytest.mark.parametrize("act", ["softplus", "elu", "swish", "lcube",
                                 "identity", "relu"])
def test_every_activation_matches_jax(act, monkeypatch):
  """A net whose activation is not sin takes the plain chain in both
  packages, the fused switch on too: no kernel wrapper is called."""
  from indm_torch.ops import fused_block as pfb
  from indm_torch.ops import neumann

  def refuse(*a, **k):
    raise AssertionError("a kernel wrapper was called")

  for mod, name in ((neumann, "neumann_chain"),
                    (neumann, "fused_neumann_chain")):
    monkeypatch.setattr(mod, name, refuse)
  monkeypatch.setattr(pfb.FusedBlockFn, "apply", refuse)
  over = {"flow.act_fn": act, "flow.actnorm": act in ("elu", "relu")}
  if act == "softplus":
    over.update(WIDE, **{"flow.fused_block": True})
  check_pair(run_pair(over))


def test_plain_chain_in_bfloat16_matches_jax():
  """`flow.logdet_bf16` with elu: the JAX package's bfloat16 XLA chain,
  every parameter cast before its normalisation."""
  check_pair(run_pair({"flow.act_fn": "elu", "flow.logdet_bf16": True}),
             bf16=True)


def test_bare_resflow_eval_estimator_matches_jax():
  """train=False: the evaluation estimator (n + 20 terms), the actnorms'
  log-dets added, on the replayed draws."""
  r = run_pair({"flow.actnorm": True}, train=False)
  z_j, ld_j, _ = r["jax"]
  z_t, ld_t, _ = r["port"]
  np.testing.assert_allclose(tts._nhwc(z_t), z_j, rtol=1e-5, atol=1e-5)
  np.testing.assert_allclose(ld_t.numpy(), ld_j, rtol=1e-4, atol=1e-4)


def test_bare_resflow_inverse_and_lipschitz_constants():
  """bwdpass inverts fwdpass through the actnorms; the Lipschitz constants
  are the JAX package's (one per conv; a scanned stack's largest)."""
  for over in ({"flow.actnorm": True}, {"flow.nblocks": "3-3"}):
    jc, tc = configs(over)
    fm = jax_fm.create_flow_model(jc)
    params, _ = fm.init(jax.random.PRNGKey(1))
    flow = torch_fm.FlowModel(tc)
    flow.load_state_dict(convert.flow_state_dict_from_jax(_np(params), tc))
    np.testing.assert_allclose(torch_fm.get_lipschitz_constants(flow),
                               jax_fm.get_lipschitz_constants(fm, params),
                               rtol=1e-6)
    x = tts._nchw(np.random.default_rng(1).uniform(-1, 1, (B, 8, 8, 3)))
    z, _ = torch_fm.flow_forward(tc, flow, x)
    xr, _ = torch_fm.flow_forward(tc, flow, z, reverse=True)
    np.testing.assert_allclose(xr.numpy(), x.numpy(), atol=5e-4)
  assert torch_fm.get_lipschitz_constants(None) == []
