"""GroupNorm(+swish) of the PyTorch port against the JAX package.

The port's wrapper computes its plain version on CPU tensors; the JAX side
runs the Pallas kernel in interpret mode, as `test_group_norm_pallas.py`
runs it, and its pure-jnp oracle. Tolerances are that test's: 1e-5 for
float32, 2e-2 for bfloat16. The CUDA kernel itself is compared with the
plain version on the card by `test_torch_cuda.py` and `chip_smoke.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indm_torch.models import layers as torch_layers
from indm_torch.ops import group_norm as gn
from indm_tpu.models import layers as jax_layers
from indm_tpu.ops import group_norm_pallas as gnp

GEOMS = [
    # (n, h, w, c, num_groups), as in test_group_norm_pallas.py
    (4, 8, 8, 32, 8),
    (6, 16, 16, 64, 16),
    (3, 32, 32, 16, 4),
    (2, 4, 4, 24, 6),
]


def _mk(n, h, w, c, seed=0):
  rng = np.random.default_rng(seed)
  x = rng.normal(size=(n, h, w, c)).astype(np.float32)
  scale = rng.normal(1.0, 0.2, size=(c,)).astype(np.float32)
  bias = rng.normal(0.0, 0.2, size=(c,)).astype(np.float32)
  return x, scale, bias


def _to_torch_nchw(x_nhwc, dtype):
  return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).contiguous().to(dtype)


@pytest.mark.parametrize("act", ["none", "swish"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", GEOMS)
def test_plain_matches_pallas_and_reference(geom, dtype, act):
  n, h, w, c, g = geom
  x, scale, bias = _mk(n, h, w, c)
  jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
  tdt = torch.float32 if dtype == "float32" else torch.bfloat16
  xj = jnp.asarray(x, dtype=jdt)
  y_kernel = gnp.fused_group_norm_act(xj, jnp.asarray(scale),
                                      jnp.asarray(bias), g, act=act,
                                      interpret=True)
  y_ref = gnp.group_norm_act_reference(xj, jnp.asarray(scale),
                                       jnp.asarray(bias), g, act=act)
  gn.reset_launches()
  xt = _to_torch_nchw(np.array(xj.astype(jnp.float32)), tdt)
  yt = gn.group_norm_act(xt, torch.from_numpy(scale), torch.from_numpy(bias),
                         g, act=act)
  assert yt.dtype == tdt
  assert gn.launches == 0  # a CPU tensor never reaches the kernel
  y_port = yt.float().permute(0, 2, 3, 1).numpy()
  tol = 1e-5 if dtype == "float32" else 2e-2
  for y in (y_kernel, y_ref):
    np.testing.assert_allclose(y_port, np.asarray(y, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("fused", [False, True])
def test_layers_groupnorm_matches_flax_path(fused):
  """The port's GroupNorm module (kernel path on or off) against the JAX
  `group_norm_act` with the fused scope off, same scale and bias; the
  tolerance of `test_layers_groupnorm_scope_equivalence`, 1e-5."""
  import flax.linen as nn

  x = np.random.default_rng(3).normal(size=(2, 8, 8, 32)).astype(np.float32)

  class M(nn.Module):

    @nn.compact
    def __call__(self, x):
      return jax_layers.group_norm_act(x, jax.nn.swish, num_groups=8)

  m = M()
  names = m.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
  assert set(names["GroupNorm_0"]) == {"scale", "bias"}
  rng = np.random.default_rng(4)
  scale = rng.normal(1.0, 0.2, size=(32,)).astype(np.float32)
  bias = rng.normal(0.0, 0.2, size=(32,)).astype(np.float32)
  params = {"params": {"GroupNorm_0": {"scale": jnp.asarray(scale),
                                       "bias": jnp.asarray(bias)}}}
  with jax_layers.fused_groupnorm_scope(False):
    y_jax = np.asarray(m.apply(params, jnp.asarray(x)))
  mod = torch_layers.GroupNorm(8, 32, act="swish", fused=fused)
  with torch.no_grad():
    mod.weight.copy_(torch.from_numpy(scale))
    mod.bias.copy_(torch.from_numpy(bias))
    y = mod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
  np.testing.assert_allclose(y.numpy(), y_jax, atol=1e-5, rtol=1e-5)


def test_wrapper_rejects_other_devices_and_inputs():
  x = torch.zeros(2, 8, 4, 4, device="meta")
  s = torch.ones(8, device="meta")
  with pytest.raises(ValueError):
    gn.group_norm_act(x, s, s, 4)
  with pytest.raises(ValueError):
    gn._check(torch.zeros(2, 6, 4, 4), torch.ones(6), torch.ones(6), 4,
              "none")
  with pytest.raises(TypeError):
    gn._check(torch.zeros(2, 8, 4, 4, dtype=torch.float16), torch.ones(8),
              torch.ones(8), 4, "none")
  with pytest.raises(ValueError):
    gn._check(torch.zeros(2, 8, 4, 4), torch.ones(8), torch.ones(8), 4,
              "gelu")


@pytest.mark.parametrize("act", ["none", "swish"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", GEOMS)
def test_backward_plain_matches_pallas_and_reference(geom, dtype, act):
  """(dx, dscale, dbias) of the port's backward (its plain version on the
  CPU) against `jax.grad` through the Pallas kernel pair in interpret mode
  and through `group_norm_act_reference`, for the cotangent of
  `test_group_norm_pallas.py:test_backward_parity` and at its tolerances:
  1e-4 (dx) and 1e-3 (dscale, dbias) in float32, 1e-1 and 1.0 in
  bfloat16."""
  n, h, w, c, g = geom
  rng = np.random.default_rng(1)
  x = rng.normal(size=(n, h, w, c)).astype(np.float32)
  scale = rng.normal(1.0, 0.2, size=(c,)).astype(np.float32)
  bias = rng.normal(0.0, 0.2, size=(c,)).astype(np.float32)
  wts = np.random.default_rng(2).normal(size=(n, h, w, c)).astype(np.float32)
  jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
  tdt = torch.float32 if dtype == "float32" else torch.bfloat16
  xj = jnp.asarray(x, dtype=jdt)

  def loss(fn):
    return lambda x, s, b: jnp.sum(fn(x, s, b, g, act=act).astype(
        jnp.float32) * wts)

  kernel = lambda *a, **k: gnp.fused_group_norm_act(*a, **k, interpret=True)
  jax_grads = [jax.grad(loss(f), argnums=(0, 1, 2))(
      xj, jnp.asarray(scale), jnp.asarray(bias))
               for f in (kernel, gnp.group_norm_act_reference)]
  gn.reset_launches()
  xt = _to_torch_nchw(np.array(xj.astype(jnp.float32)), tdt)
  dy = _to_torch_nchw(wts, tdt)
  dx, ds, db = gn.group_norm_act_backward(xt, dy, torch.from_numpy(scale),
                                          torch.from_numpy(bias), g, act=act)
  assert gn.bwd_launches == 0 and dx.dtype == tdt
  tol = 1e-4 if dtype == "float32" else 1e-1
  for gx, gs, gb in jax_grads:
    np.testing.assert_allclose(dx.float().permute(0, 2, 3, 1).numpy(),
                               np.asarray(gx, np.float32), atol=tol, rtol=tol)
    np.testing.assert_allclose(ds.numpy(), np.asarray(gs), atol=tol * 10,
                               rtol=tol)
    np.testing.assert_allclose(db.numpy(), np.asarray(gb), atol=tol * 10,
                               rtol=tol)


def test_layer_trains_through_the_autograd_function():
  """The fused GroupNorm module's gradients (`GroupNormAct` on the CPU: the
  plain forward and backward) against autograd of the plain forward."""
  rng = np.random.default_rng(5)
  x = torch.from_numpy(rng.normal(size=(2, 16, 4, 4)).astype(np.float32))
  mod = torch_layers.GroupNorm(4, 16, act="swish", fused=True)
  with torch.no_grad():
    mod.weight.copy_(torch.from_numpy(rng.normal(1.0, 0.2, 16).astype(
        np.float32)))
  xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
  wts = torch.from_numpy(rng.normal(size=(2, 16, 4, 4)).astype(np.float32))
  (mod(xa) * wts).sum().backward()
  got = [xa.grad, mod.weight.grad, mod.bias.grad]
  s = mod.weight.detach().clone().requires_grad_()
  b = mod.bias.detach().clone().requires_grad_()
  (gn.group_norm_act_plain(xb, s, b, 4, act="swish") * wts).sum().backward()
  for a, want in zip(got, (xb.grad, s.grad, b.grad)):
    torch.testing.assert_close(a, want, atol=1e-5, rtol=1e-5)
