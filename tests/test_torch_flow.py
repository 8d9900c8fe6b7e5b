"""The port's flow inverse against the JAX package: LopConv2d, the
Lipschitz net of an iResBlock, the fixed-point inverse, the multi-scale
`bwdpass`, the prior flow's sample pass and `flow_forward(reverse=True)`
with the JAX noise replayed; and the weight round trip through the JAX
package's converters.

Geometry: the tiny config of `tests/test_golden.py` with a two-scale flow
(`nblocks="2-2"`), so that the squeeze between scales is covered.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indm_torch import configs as torch_configs
from indm_torch import convert
from indm_torch.flows import flow_model as torch_fm
from indm_torch.flows import lipschitz as torch_lip
from indm_torch.flows import resflow as torch_resflow
from indm_tpu import configs as jax_configs
from indm_tpu.flows import convert as jax_flow_convert
from indm_tpu.flows import flow_model as jax_fm
from indm_tpu.flows import lipschitz as jax_lip
from indm_tpu.flows import resflow as jax_resflow
from torch_threads import one_torch_thread  # noqa: F401

TINY = {"data.image_size": 8, "flow.nblocks": "2-2",
        "flow.intermediate_dim": 8}
# float32 convs and sums taken in another order: a few ulp of the values
TOL = 1e-5


def _set(cfg, name, value):
  *path, leaf = name.split(".")
  node = cfg
  for p in path:
    node = getattr(node, p)
  setattr(node, leaf, value)


def tiny_configs():
  jc = jax_configs.get_config("vp/CIFAR10/indm_nll")
  tc = torch_configs.get_config("vp/CIFAR10/indm_nll")
  for k, v in TINY.items():
    _set(jc, k, v)
    _set(tc, k, v)
  return jc, tc


def _nchw(x):
  return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(
      0, 3, 1, 2)))


def _nhwc(x):
  return x.permute(0, 2, 3, 1).detach().numpy()


@pytest.fixture(scope="module")
def flows():
  jc, tc = tiny_configs()
  fm = jax_fm.create_flow_model(jc)
  params, buffers = fm.init(jax.random.PRNGKey(1))
  params_np = jax.tree_util.tree_map(np.asarray, params)
  model = torch_fm.FlowModel(tc)
  model.load_state_dict(convert.flow_state_dict_from_jax(params_np, tc),
                        strict=True)
  model.eval()
  return jc, tc, fm, params, buffers, params_np, model


def _h(n=4, dim=64, seed=7):
  return np.random.default_rng(seed).normal(size=(n, dim)).astype(np.float32)


def test_lopconv2d_matches():
  rng = np.random.default_rng(0)
  for k, cond in ((3, None), (1, 5)):
    jc = jax_lip.LopConv2d(4, 6, k, 0.98, cond_dim=cond)
    p = jc.init(jax.random.PRNGKey(k))
    # scale the weight up so the operator-norm bound is active
    p = dict(p, w=p["w"] * 4.0)
    tc = torch_lip.LopConv2d(4, 6, k, 0.98, cond_dim=cond)
    with torch.no_grad():
      tc.weight.copy_(torch.from_numpy(np.array(p["w"]).transpose(3, 2, 0,
                                                                     1)))
      tc.bias.copy_(torch.from_numpy(np.array(p["b"])))
      if cond:
        tc.h_net.net.weight.copy_(torch.from_numpy(np.array(p["h_w"]).T))
        tc.h_net.net.bias.copy_(torch.from_numpy(np.array(p["h_b"])))
    x = rng.normal(size=(2, 5, 5, 4)).astype(np.float32)
    h = rng.normal(size=(2, 5)).astype(np.float32) if cond else None
    y_j = jc.apply(p, jnp.asarray(x), h=None if h is None else jnp.asarray(h))
    with torch.no_grad():
      y_t = tc(_nchw(x), None if h is None else torch.from_numpy(h))
    np.testing.assert_allclose(_nhwc(y_t), np.asarray(y_j), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(
        tc.normalized_weight().detach().numpy().transpose(2, 3, 1, 0),
        np.asarray(jc.normalized_weight(p)), atol=1e-7, rtol=1e-6)


def test_squeeze_channel_order_matches():
  x = np.arange(2 * 4 * 4 * 3, dtype=np.float32).reshape(2, 4, 4, 3)
  y_j = np.asarray(jax_resflow.squeeze_nhwc(jnp.asarray(x)))
  y_t = torch_resflow.squeeze(_nchw(x))
  np.testing.assert_array_equal(_nhwc(y_t), y_j)
  np.testing.assert_array_equal(_nhwc(torch_resflow.unsqueeze(y_t)), x)


def test_iresblock_g_and_inverse_match(flows):
  """Block 0 of scale 0 (no pre-activation) and block 1 (pre-activated):
  g(x) as `LipschitzNNet.apply` computes it, and the fixed-point inverse
  of y = x + g(x)."""
  jc, tc, fm, params, _, _, model = flows
  h = _h()
  x = np.random.default_rng(1).normal(size=(4, 8, 8, 3)).astype(np.float32)
  j_layers = fm.resflow.transforms[0].layers
  j_params = params["resflow"][0]
  for b in (0, 1):
    j_block, jp = j_layers[b], j_params[b]
    t_block = model.resflow.transforms[0].chain[b]
    g_j = j_block.nnet.apply(jp["nnet"], jnp.asarray(x), h=jnp.asarray(h))
    with torch.no_grad():
      g_t = t_block.g(_nchw(x), torch.from_numpy(h))
    np.testing.assert_allclose(_nhwc(g_t), np.asarray(g_j), atol=TOL,
                               rtol=TOL)
    y = x + np.asarray(g_j)
    x_j, _ = j_block.inverse(jp, jnp.asarray(y), h=jnp.asarray(h))
    with torch.no_grad():
      x_t, steps = t_block.inverse(_nchw(y), torch.from_numpy(h))
    assert steps > 0
    np.testing.assert_allclose(_nhwc(x_t), np.asarray(x_j), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(_nhwc(x_t), x, atol=1e-3)


def test_bwdpass_matches(flows):
  jc, tc, fm, params, _, _, model = flows
  h = _h(seed=2)
  z = np.random.default_rng(3).normal(size=(4, 8, 8, 3)).astype(np.float32)
  x_j, _ = fm.resflow.bwdpass(params["resflow"], jnp.asarray(z),
                              h=jnp.asarray(h))
  x_t, _ = model.resflow.bwdpass(_nchw(z), torch.from_numpy(h))
  assert len(model.resflow.last_inverse_steps) == 4
  np.testing.assert_allclose(_nhwc(x_t), np.asarray(x_j), atol=TOL,
                             rtol=TOL)


def _disc_vars(params, buffers):
  return {"params": params["disc"], "batch_stats": buffers["batch_stats"]}


def test_prior_sample_pass_matches(flows):
  """The 64x64 inverse of `InvertibleLinearFlow` runs in float64 in the
  port and float32 in JAX; 1e-4 covers that."""
  jc, tc, fm, params, buffers, _, model = flows
  eps = _h(seed=4)
  z_j, _ = fm.disc.apply(_disc_vars(params, buffers), jnp.asarray(eps),
                         method=lambda m, e: m.prior.sample_pass(e))
  z_t = model.discriminator.sample_from_prior(4, epsilon=torch.from_numpy(eps))
  np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=1e-4,
                             rtol=1e-4)


def replay_prior_eps(fm, params, buffers, n, rng=None):
  """The epsilon that `flow_forward(reverse=True)` draws for the prior:
  `split(rng)` -> rng_h -> the discriminator's 'sample' stream."""
  rng = jax.random.PRNGKey(0) if rng is None else rng
  rng_h, _ = jax.random.split(rng)
  return np.array(fm.disc.apply(
      _disc_vars(params, buffers), n,
      method=lambda m, n: jax.random.normal(m.make_rng("sample"), (n, m.dim)),
      rngs={"sample": rng_h}))


def test_flow_forward_reverse_matches_with_replayed_noise(flows):
  jc, tc, fm, params, buffers, _, model = flows
  x = np.random.default_rng(5).normal(size=(4, 8, 8, 3)).astype(np.float32)
  z_j, _, _ = jax_fm.flow_forward(jc, fm, params, buffers, jnp.asarray(x),
                                  rng=None, reverse=True)
  eps = replay_prior_eps(fm, params, buffers, 4)
  z_t, _ = torch_fm.flow_forward(tc, model, _nchw(x), reverse=True,
                                 prior_eps=torch.from_numpy(eps))
  np.testing.assert_allclose(_nhwc(z_t), np.asarray(z_j), atol=1e-4,
                             rtol=1e-4)


def test_flow_weights_round_trip(flows):
  """JAX params -> port state_dict -> the JAX package's torch converters
  (`resflow_params_from_torch`, `_prior_step`) -> the same JAX params."""
  jc, tc, _, _, _, params_np, model = flows
  sd = model.state_dict()
  back = jax_flow_convert.resflow_params_from_torch(sd, jc)
  a = jax.tree_util.tree_leaves_with_path(params_np["resflow"])
  b = dict(jax.tree_util.tree_leaves_with_path(back))
  assert len(a) == len(b)
  for path, leaf in a:
    np.testing.assert_array_equal(np.asarray(b[path]), leaf)
  for i in range(2):
    step = jax_flow_convert._prior_step(
        sd, f"discriminator.prior.flow.steps.{i}")
    a = jax.tree_util.tree_leaves_with_path(
        params_np["disc"]["prior"][f"steps_{i}"])
    b = dict(jax.tree_util.tree_leaves_with_path(step))
    assert len(a) == len(b)
    for path, leaf in a:
      np.testing.assert_array_equal(np.asarray(b[path]), leaf)
