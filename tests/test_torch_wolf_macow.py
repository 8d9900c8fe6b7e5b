"""The port's MaCow (`indm_torch.flows.wolf_macow`) against the JAX
package's (`indm_tpu/flows/wolf_macow.py`).

`MaskedConvFlow` for orders A-D (conditioned on a global h and not): its
forward and its autoregressive inverse, with their log-dets, against the
JAX flow on the same weights (to 1e-5 of the largest value, the log-dets
to 1e-4), its round trip at the JAX package's own 1e-5
(`tests/test_wolf_flows.py:48`), and its autoregressive property; the
shifted conv; a small MaCow both ways, with the gradients of the encoding
(sequential) direction to rtol 1e-4, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train_step as tts
from indm_torch.flows import wolf_macow as tm
from indm_tpu.flows import wolf_macow as jm
from test_torch_wolf_glow import perturbed, port_module, _np
from indm_torch import convert
from torch_threads import one_torch_thread  # noqa: F401

ORDERS = [("A", (2, 3)), ("B", (2, 3)), ("C", (3, 2)), ("D", (3, 2))]


@pytest.mark.parametrize("order,ks", ORDERS)
@pytest.mark.parametrize("cond", [False, True])
def test_masked_conv_flow_matches_jax(order, ks, cond):
  rng = np.random.default_rng(0)
  x = rng.normal(size=(2, 6, 5, 3)).astype(np.float32)
  h = rng.normal(size=(2, 4)).astype(np.float32) if cond else None
  kw = dict(in_channels=3, kernel_size=ks, order=order, activation="elu",
            h_type="global_linear" if cond else None,
            h_channels=4 if cond else 0)
  mj = jm.MaskedConvFlow(**kw)
  hj = None if h is None else jnp.asarray(h)
  ht = None if h is None else torch.from_numpy(h)
  v = perturbed(mj.init(jax.random.PRNGKey(1), jnp.asarray(x), h=hj,
                        train=False), scale=0.2)
  mt = port_module(tm.MaskedConvFlow(**kw), v)
  for reverse in (False, True):
    out_j, ld_j = mj.apply(v, jnp.asarray(x), h=hj, reverse=reverse,
                           train=False)
    out_t, ld_t = mt(tts._nchw(x), ht, reverse=reverse)
    big = float(np.abs(np.asarray(out_j)).max())
    np.testing.assert_allclose(tts._nhwc(out_t), np.asarray(out_j), rtol=0,
                               atol=1e-5 * big)
    np.testing.assert_allclose(ld_t.detach().numpy(), np.asarray(ld_j),
                               rtol=1e-4, atol=1e-4)
  y, ld = mt(tts._nchw(x), ht)
  back, ld_inv = mt(y, ht, reverse=True)
  np.testing.assert_allclose(back.detach().numpy(), tts._nchw(x).numpy(),
                             atol=1e-5)
  np.testing.assert_allclose((ld + ld_inv).detach().numpy(), 0.0, atol=1e-4)


@pytest.mark.parametrize("order,ks", ORDERS)
def test_masked_conv_flow_is_autoregressive(order, ks):
  """An output pixel's shift depends only on the rows (A: above, B:
  below) or columns (C: left, D: right) strictly before it: a change past
  row or column 3 leaves the others' y - x as they were, in the port as in
  the JAX flow."""
  rng = np.random.default_rng(5)
  x = rng.normal(size=(1, 6, 6, 2)).astype(np.float32)
  kw = dict(in_channels=2, kernel_size=ks, order=order,
            transform="additive")
  mj = jm.MaskedConvFlow(**kw)
  v = perturbed(mj.init(jax.random.PRNGKey(6), jnp.asarray(x), train=False))
  mt = port_module(tm.MaskedConvFlow(**kw), v)
  x2 = x.copy()
  axis = 1 if order in ("A", "B") else 2
  later = (slice(None),) * axis + ((slice(4, None) if order in ("A", "C")
                                    else slice(0, 2)),)
  keep = (slice(None),) * axis + ((slice(0, 4) if order in ("A", "C")
                                   else slice(2, None)),)
  x2[later] = 7.0
  outs = []
  for xx in (x, x2):
    y_t, _ = mt(tts._nchw(xx))
    y_j, _ = mj.apply(v, jnp.asarray(xx), train=False)
    np.testing.assert_allclose(tts._nhwc(y_t), np.asarray(y_j), atol=1e-5)
    outs.append((tts._nhwc(y_t) - xx)[keep])
  np.testing.assert_allclose(outs[0], outs[1], atol=1e-6)
  assert not np.allclose(tts._nhwc(mt(tts._nchw(x2))[0]) - x2,
                         tts._nhwc(mt(tts._nchw(x))[0]) - x)


@pytest.mark.parametrize("order", ["A", "B", "C", "D"])
def test_shifted_conv_matches_jax(order):
  rng = np.random.default_rng(2)
  x = rng.normal(size=(2, 5, 6, 3)).astype(np.float32)
  ks = (2, 3) if order in ("A", "B") else (3, 2)
  mj = jm.ShiftedConv2d(4, ks, order=order)
  v = mj.init(jax.random.PRNGKey(3), jnp.asarray(x))
  mt = port_module(tm.ShiftedConv2d(3, 4, ks, order), v)
  np.testing.assert_allclose(tts._nhwc(mt(tts._nchw(x))),
                             np.asarray(mj.apply(v, jnp.asarray(x))),
                             rtol=1e-5, atol=1e-5)


def test_small_macow_matches_jax():
  """Two levels (MaCow steps of two units each, kernel 2x3), conditioned on
  a global h: both ways, the gradients of the encoding direction."""
  kw = dict(levels=2, num_steps=[1, 1], in_channels=3, factors=[],
            hidden_channels=[8, 8], kernel_size=(2, 3), activation="elu",
            h_channels=4, h_type="global_linear")
  rng = np.random.default_rng(7)
  x = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
  h = rng.normal(size=(2, 4)).astype(np.float32)
  gj = jm.MaCow(**kw)
  v = perturbed(gj.init(jax.random.PRNGKey(8), jnp.asarray(x),
                        h=jnp.asarray(h), train=False), scale=0.05)
  gt = port_module(tm.MaCow(**kw), v)
  w = rng.normal(size=x.shape).astype(np.float32)

  def loss(p, reverse):
    z, ld = gj.apply({"params": p}, jnp.asarray(x), h=jnp.asarray(h),
                     reverse=reverse, train=False)
    return jnp.sum(ld) + jnp.sum(z * w), (z, ld)

  for reverse in (False, True):
    (_, (z_j, ld_j)), g_j = jax.jit(jax.value_and_grad(
        loss, has_aux=True), static_argnums=1)(v["params"], reverse)
    gt.zero_grad()
    z_t, ld_t = gt(tts._nchw(x), torch.from_numpy(h), reverse=reverse)
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


def test_macow_refuses_other_transforms_as_jax():
  with pytest.raises(KeyError):
    jm.MaskedConvFlow(3, (2, 3), transform="nlsq").init(
        jax.random.PRNGKey(0), jnp.ones((1, 4, 4, 3)), train=False)
  with pytest.raises(KeyError, match="nlsq"):
    tm.MaskedConvFlow(3, (2, 3), transform="nlsq")
