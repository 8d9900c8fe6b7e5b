"""GroupNorm(+swish) of the PyTorch port against the JAX package.

The port's wrapper computes its plain version on CPU tensors; the JAX side
runs the Pallas kernel in interpret mode, as `test_group_norm_pallas.py`
runs it, and its pure-jnp oracle. Tolerances are that test's: 1e-5 for
float32, 2e-2 for bfloat16. The CUDA kernel itself is compared with the
plain version on the card by `test_torch_cuda.py` and `chip_smoke.py`.
"""

import collections
import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indm_torch.models import layers as torch_layers
from indm_torch.ops import group_norm as gn
from indm_tpu.models import layers as jax_layers
from indm_tpu.ops import group_norm_pallas as gnp
from torch_threads import one_torch_thread  # noqa: F401

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


def test_layer_without_gradients_skips_the_autograd_function(monkeypatch):
  """Where nothing needs a gradient (no_grad, or no input that requires
  one) the fused layer calls `group_norm_act` alone, with the output of
  the `GroupNormAct` route; with a gradient it goes through `GroupNormAct`;
  a device the wrapper does not take is refused on both routes."""
  rng = np.random.default_rng(6)
  x = torch.from_numpy(rng.normal(size=(2, 16, 4, 4)).astype(np.float32))
  mod = torch_layers.GroupNorm(4, 16, act="swish", fused=True)
  with torch.no_grad():
    mod.weight.copy_(torch.from_numpy(rng.normal(1.0, 0.2, 16).astype(
        np.float32)))
  want = gn.GroupNormAct.apply(x, mod.weight, mod.bias, 4, 1e-6, "swish")
  calls = []
  apply = gn.GroupNormAct.apply
  monkeypatch.setattr(gn.GroupNormAct, "apply",
                      lambda *a: calls.append(1) or apply(*a))
  with torch.no_grad():
    got = mod(x)
  assert not calls and not got.requires_grad
  torch.testing.assert_close(got, want.detach(), atol=0, rtol=0)
  mod.requires_grad_(False)
  assert torch.equal(mod(x), got) and not calls
  mod.requires_grad_(True)
  assert torch.equal(mod(x).detach(), got) and calls == [1]
  meta = torch.zeros(2, 16, 4, 4, device="meta")
  for grad in (False, True):
    with torch.set_grad_enabled(grad), pytest.raises(ValueError,
                                                     match="cpu or cuda"):
      mod(meta)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
  spec = importlib.util.spec_from_file_location(
      "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
  cs = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(cs)
  return cs


def _net_group_norms(config):
  """{(C, H, W, groups, act): launches} of one forward of the full-width
  net of `config` at batch 1 on the CPU, from forward pre-hooks."""
  from indm_torch.configs import get_config
  from indm_torch.models.registry import create_model
  cfg = get_config(config)
  cfg.model.fused_groupnorm = True
  model = create_model(cfg, seed=0, device="cpu")
  seen = collections.Counter()
  hooks = [m.register_forward_pre_hook(
      lambda mod, args: seen.update([(*args[0].shape[1:], mod.num_groups,
                                      mod.act)]))
           for m in model.modules() if isinstance(m, torch_layers.GroupNorm)]
  size = cfg.data.image_size
  with torch.no_grad():
    model(torch.zeros(1, 3, size, size), torch.full((1,), 0.5))
  for h in hooks:
    h.remove()
  return seen


# a row of the backward's plan table in `group_norm.cu`'s note: threads x
# chunks a row, or "one block" (the one-block-a-row kernel)
_PLAN_ROW = re.compile(r"^//\s+(\d+) x (\d+) x (\d+)\s+(\d+)\s+(\d+)\s+"
                       r"(?:(\d+) x (\d+)|one block)\s+(\d+)\s+([\d.]+)$",
                       re.M)


@pytest.mark.parametrize("config", ["vp/CIFAR10/indm_nll", "ve/CIFAR10/indm",
                                    "vp/CELEBA/indm_nll", "ve/CELEBA/indm"])
def test_net_shapes_match_the_backward_plan_in_the_source(config):
  """The full-width nets' GroupNorm calls (hooks at batch 1) against the
  table in `group_norm.cu`'s note for their image size (the 32x32 table,
  then the 64x64 one after "At 64x64"): the same (C, H, W) with the same
  launches, GN_PER_SCORE_EVAL (chip_smoke.py) in all, G = 32; each row's
  values, the wrapper's row plan (`bwd_plan`: threads x chunks, rows a
  block; the one-block-a-row kernel where it says so) and its bound at
  batch 128 in float32."""
  cs = _chip_smoke()
  seen = _net_group_norms(config)
  assert sum(seen.values()) == cs.GN_PER_SCORE_EVAL == 95
  assert {k[3] for k in seen} == {32}
  by_shape = collections.Counter()
  for (c, h, w, _, _), count in seen.items():
    by_shape[(c, h, w)] += count
  big = "CELEBA" in config
  note = open(os.path.join(REPO, "indm_torch", "csrc",
                           "group_norm.cu")).read().split("At 64x64")
  table = _PLAN_ROW.findall(note[int(big)])
  assert len(table) == len(by_shape) == 11
  total = 0.0
  for c, h, w, launches, values, tpr, chunks, rows, bound in table:
    c, h, w = int(c), int(h), int(w)
    assert by_shape[(c, h, w)] == int(launches), (c, h, w)
    assert c // 32 * h * w == int(values)
    log2, nv = gn.bwd_plan(c, h * w, 32, 4, True)
    if not tpr:  # one block a row
      assert (log2, nv, int(rows)) == (0, 0, 1), (c, h, w)
    else:
      thread_chunks = -(-(c // 32 * h * w // 4) // (1 << log2))
      assert (1 << log2, thread_chunks) == (int(tpr), int(chunks))
      assert nv >= thread_chunks and max(1 << log2, 256) >> log2 == int(rows)
    us = 3 * cs.TRAIN_BATCH * c * h * w * 4 / cs.HBM_BYTES_PER_S * 1e6
    assert abs(us - float(bound)) <= 0.05, (c, h, w, us)
    total += int(launches) * us
  assert abs(total / 1e3 - (10.983 if big else 2.858)) < 5e-4


@pytest.mark.parametrize("n,c,hw,g,es,vec,want", [
    (2, 32, 1024, 1, 4, True, (0, 0)),   # 32768 values: one block a row
    (2, 512, 49, 32, 4, False, (8, 4)),  # the scalar path: 784 values
    (2, 512, 64 * 64, 32, 4, False, (0, 0)),
    (2, 384, 1024, 32, 2, True, (9, 4)),  # bfloat16: 8 values a chunk
    (2, 4096, 4, 1, 4, True, (0, 0)),    # 4096 channels' sums: over 48 KB
])
def test_backward_plan_branches(n, c, hw, g, es, vec, want):
  """The backward plan's other branches: rows beyond 1024 threads of 4
  chunks, or whose block would take over 48 KB of shared memory, take the
  one-block-a-row kernel ((0, 0)); the scalar path takes one value a
  chunk; bfloat16 eight."""
  assert gn.bwd_plan(c, hw, g, es, vec) == want
