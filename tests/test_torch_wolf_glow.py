"""The port's Glow pieces (`indm_torch.flows.wolf_glow`) against the JAX
package's (`indm_tpu/flows/wolf_glow.py`).

Each coupling transform both ways with its log-det on the same numpy
inputs (to 1e-5; nlsq's inverse solves a cubic in float32 in both, 1e-4,
and round-trips at the JAX package's own 2e-3, `tests/test_wolf_flows.py:
190`); `NICE2d` with each transform, conditioned on a global h and not;
`ActNorm2dFlow`, `Conv1x1Flow` and the weight-normalised conv; a small
Glow both ways with the gradients of its encoding direction, its weights
carried over from a JAX init moved off its zero-initialised convs (the
outputs to 1e-5 of the largest value, the log-dets to 1e-4, the
gradients to rtol 1e-4, atol 1e-5); the data-dependent init's statistics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train_step as tts
from indm_torch import convert
from indm_torch.flows import wolf_glow as tg
from indm_tpu.flows import wolf_glow as jg
from torch_threads import one_torch_thread  # noqa: F401


def _np(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


def perturbed(variables, scale=0.1, seed=9):
  """A JAX init moved off its zero-initialised last convs, leaf by leaf."""
  leaves, tree = jax.tree_util.tree_flatten(variables["params"])
  keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
  leaves = [a + scale * jax.random.normal(k, a.shape)
            for a, k in zip(leaves, keys)]
  return {"params": jax.tree_util.tree_unflatten(tree, leaves)}


def port_module(mod, variables):
  mod.load_state_dict(convert.wolf_module_state_dict_from_jax(
      mod, _np(variables["params"])), strict=True)
  return mod


@pytest.mark.parametrize("name", sorted(jg._TRANSFORMS))
def test_transform_both_ways_matches_jax(name):
  fn_j, mult = jg._TRANSFORMS[name]
  fn_t, _ = tg.TRANSFORMS[name]
  rng = np.random.default_rng(0)
  zp = rng.normal(size=(3, 4, 5, 2)).astype(np.float32) * 0.8
  params = (rng.normal(size=(3, 4, 5, 2 * mult)) * 0.3).astype(np.float32)
  # NHWC, the channel split along the last axis, as the JAX transforms
  # take it; NCHW (the split along channels) in the port
  p_t, z_t = tts._nchw(params), tts._nchw(zp)
  tol = 1e-4 if name == "nlsq" else 1e-5
  for reverse in (False, True):
    out_j, ld_j = fn_j(jnp.asarray(params), jnp.asarray(zp), reverse, 1.0)
    out_t, ld_t = fn_t(p_t, z_t, reverse, 1.0)
    np.testing.assert_allclose(tts._nhwc(out_t), np.asarray(out_j),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(ld_t.numpy(), np.asarray(ld_j), rtol=tol,
                               atol=tol)
  y, ld = fn_t(p_t, z_t, False, 1.0)
  back, ld_inv = fn_t(p_t, y, True, 1.0)
  if name != "symm_elu":   # its reverse is the reference's approximation
    np.testing.assert_allclose(back.numpy(), z_t.numpy(), atol=2e-3)
  if name not in ("symm_elu", "nlsq"):
    np.testing.assert_allclose((ld + ld_inv).numpy(), 0.0, atol=1e-5)


@pytest.mark.parametrize("transform", ["affine", "additive", "relu", "nlsq",
                                       "symm_elu"])
@pytest.mark.parametrize("cond", [False, True])
def test_nice2d_matches_jax(transform, cond):
  """The coupling on 6 channels, continuous and skip splits, up and down."""
  rng = np.random.default_rng(1)
  x = rng.normal(size=(2, 4, 4, 6)).astype(np.float32)
  h = rng.normal(size=(2, 5)).astype(np.float32) if cond else None
  for split, order in (("continuous", "up"), ("skip", "down")):
    kw = dict(in_channels=6, hidden_channels=8, split_type=split,
              order=order, transform=transform, activation="elu",
              h_type="global_linear" if cond else None,
              h_channels=5 if cond else 0)
    mj = jg.NICE2d(**kw)
    v = perturbed(mj.init(jax.random.PRNGKey(2), jnp.asarray(x),
                          h=None if h is None else jnp.asarray(h),
                          train=False))
    mt = port_module(tg.NICE2d(**kw), v)
    ht = None if h is None else torch.from_numpy(h)
    for reverse in (False, True):
      out_j, ld_j = mj.apply(v, jnp.asarray(x),
                             h=None if h is None else jnp.asarray(h),
                             reverse=reverse, train=False)
      out_t, ld_t = mt(tts._nchw(x), ht, reverse=reverse)
      np.testing.assert_allclose(tts._nhwc(out_t), np.asarray(out_j),
                                 rtol=1e-4, atol=1e-4)
      np.testing.assert_allclose(ld_t.detach().numpy(), np.asarray(ld_j),
                                 rtol=1e-4, atol=1e-4)


def test_actnorm_conv1x1_and_weight_norm_conv_match_jax():
  rng = np.random.default_rng(3)
  x = rng.normal(size=(2, 4, 4, 5)).astype(np.float32)
  for mj, mt in ((jg.ActNorm2dFlow(5), tg.ActNorm2dFlow(5)),
                 (jg.Conv1x1Flow(5), tg.Conv1x1Flow(5))):
    v = perturbed(mj.init(jax.random.PRNGKey(4), jnp.asarray(x)))
    port_module(mt, v)
    for reverse in (False, True):
      out_j, ld_j = mj.apply(v, jnp.asarray(x), reverse=reverse)
      out_t, ld_t = mt(tts._nchw(x), reverse=reverse)
      np.testing.assert_allclose(tts._nhwc(out_t), np.asarray(out_j),
                                 rtol=1e-5, atol=1e-5)
      np.testing.assert_allclose(ld_t.detach().numpy(), np.asarray(ld_j),
                                 rtol=1e-5, atol=1e-5)
  mj = jg.Conv2dWeightNorm(7, (3, 3))
  v = perturbed(mj.init(jax.random.PRNGKey(5), jnp.asarray(x)))
  mt = port_module(tg.Conv2dWeightNorm(5, 7, (3, 3)), v)
  np.testing.assert_allclose(tts._nhwc(mt(tts._nchw(x))),
                             np.asarray(mj.apply(v, jnp.asarray(x))),
                             rtol=1e-5, atol=1e-5)


def test_data_dependent_init_standardises_like_jax():
  """Within `data_dependent_init` an actnorm's output is standardised per
  channel in the direction it runs and a weight-normalised conv's output
  scaled to its init_scale (0 for the coupling blocks' last convs)."""
  rng = np.random.default_rng(6)
  x = (2.0 + 3.0 * rng.normal(size=(8, 4, 4, 3))).astype(np.float32)
  for reverse in (False, True):
    mj = jg.ActNorm2dFlow(3)
    v = mj.init(jax.random.PRNGKey(0), jnp.asarray(x), reverse=reverse)
    mt = tg.ActNorm2dFlow(3)
    with tg.data_dependent_init():
      mt(tts._nchw(x), reverse=reverse)
    np.testing.assert_allclose(mt.log_scale.detach().numpy(),
                               np.asarray(v["params"]["log_scale"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mt.bias.detach().numpy(),
                               np.asarray(v["params"]["bias"]), rtol=1e-5,
                               atol=1e-6)
  mt = tg.Conv2dWeightNorm(3, 4, (3, 3), init_scale=1.0)
  with tg.data_dependent_init():
    y = mt(tts._nchw(x))
  np.testing.assert_allclose(y.mean(dim=(0, 2, 3)).detach().numpy(), 0.0,
                             atol=1e-5)
  np.testing.assert_allclose(
      y.std(dim=(0, 2, 3), unbiased=False).detach().numpy(), 1.0, atol=1e-3)
  zero = tg.Conv2dWeightNorm(3, 4, (3, 3), init_scale=0.0)
  with tg.data_dependent_init():
    assert float(zero(tts._nchw(x)).detach().abs().max()) == 0.0


GLOW = dict(levels=3, num_steps=[1, [1, 1], 1], in_channels=3, factors=[3],
            hidden_channels=[8, 8, 8], activation="elu")


@pytest.mark.parametrize("cond", [False, True])
def test_small_glow_matches_jax(cond):
  """Three levels (an internal one with two priors): both ways, and the
  gradients of the encoding (reverse) direction, as the presets train."""
  kw = dict(GLOW, **({"h_channels": 6, "h_type": "global_linear"} if cond
                     else {}))
  rng = np.random.default_rng(7)
  x = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
  h = rng.normal(size=(2, 6)).astype(np.float32) if cond else None
  hj = None if h is None else jnp.asarray(h)
  ht = None if h is None else torch.from_numpy(h)
  gj = jg.Glow(**kw)
  v = perturbed(gj.init(jax.random.PRNGKey(1), jnp.asarray(x), h=hj,
                        train=False), scale=0.05)
  gt = port_module(tg.Glow(**kw), v)
  w = rng.normal(size=x.shape).astype(np.float32)

  def loss(p, reverse):
    z, ld = gj.apply({"params": p}, jnp.asarray(x), h=hj, reverse=reverse,
                     train=False)
    return jnp.sum(ld) + jnp.sum(z * w), (z, ld)

  for reverse in (False, True):
    (_, (z_j, ld_j)), g_j = jax.value_and_grad(loss, has_aux=True)(
        v["params"], reverse)
    gt.zero_grad()
    z_t, ld_t = gt(tts._nchw(x), ht, reverse=reverse)
    (ld_t.sum() + (z_t * tts._nchw(w)).sum()).backward()
    big = float(np.abs(np.asarray(z_j)).max())
    np.testing.assert_allclose(tts._nhwc(z_t), np.asarray(z_j), rtol=0,
                               atol=1e-5 * big)
    np.testing.assert_allclose(ld_t.detach().numpy(), np.asarray(ld_j),
                               rtol=1e-4, atol=1e-4)
    want = convert.wolf_module_state_dict_from_jax(gt, _np(g_j))
    for name, p in gt.named_parameters():
      np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                 rtol=1e-4, atol=1e-5, err_msg=name)
  z_t, _ = gt(tts._nchw(x), ht, reverse=True)
  back, _ = gt(z_t, ht)
  np.testing.assert_allclose(back.detach().numpy(), tts._nchw(x).numpy(),
                             atol=1e-5)


def test_flow_registry_and_split_helpers():
  from indm_torch.flows import wolf_macow  # noqa: F401
  assert tg.flow_by_name("glow") is tg.Glow
  assert tg.flow_by_name("macow").__name__ == "MaCow"
  x = torch.arange(2 * 8 * 4 * 4, dtype=torch.float32).reshape(2, 8, 4, 4)
  xj = jnp.asarray(tts._nhwc(x))
  np.testing.assert_array_equal(tts._nhwc(tg.squeeze2d(x)),
                                np.asarray(jg.squeeze2d(xj)))
  np.testing.assert_array_equal(tts._nhwc(tg.unsqueeze2d(x)),
                                np.asarray(jg.unsqueeze2d(xj)))
  a, b = tg.split2d(x, 3)
  aj, bj = jg.split2d(xj, 3)
  np.testing.assert_array_equal(tts._nhwc(a), np.asarray(aj))
  np.testing.assert_array_equal(tts._nhwc(tg.unsplit2d([a, b])),
                                np.asarray(jg.unsplit2d([aj, bj])))


def test_nice_conv_block_normalize_choices():
  """group_norm and batch_norm against the JAX block; instance_norm fails
  in both (the JAX block names both norms' parameters alike)."""
  rng = np.random.default_rng(8)
  x = rng.normal(size=(4, 4, 4, 3)).astype(np.float32)
  for norm, ng in (("group_norm", 2), ("batch_norm", None)):
    mj = jg.NICEConvBlock(5, 8, activation="elu", normalize=norm,
                          num_groups=ng)
    v = mj.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    v = {**perturbed(v), **{k: c for k, c in v.items() if k != "params"}}
    mt = tg.NICEConvBlock(3, 5, 8, "elu", norm, ng).eval()
    mt.load_state_dict(convert.wolf_module_state_dict_from_jax(
        mt, _np(v["params"])), strict=True)
    np.testing.assert_allclose(
        tts._nhwc(mt(tts._nchw(x))),
        np.asarray(mj.apply(v, jnp.asarray(x), train=False)), rtol=1e-4,
        atol=1e-4)
  with pytest.raises(Exception):
    jg.NICEConvBlock(5, 8, normalize="instance_norm").init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False)
  with pytest.raises(NotImplementedError, match="instance_norm"):
    tg.NICEConvBlock(3, 5, 8, "elu", "instance_norm")
