"""The port's upfirdn2d (kernel 9's plain version, which a CPU tensor takes),
its four resampling functions and the FIR layers against the JAX package.

The plain version is held against the oracle `upfirdn2d_native` and the
TPU kernel in interpret mode at the three cases of `tests/test_ops.py`
and at the (up, down, pad) triples of the VE score net, with the JAX
test's own tolerance, atol 1e-5. Images are NHWC on the JAX side and
NCHW in the port; weights HWIO and OIHW.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indm_torch.models import layers as torch_layers
from indm_torch.ops import upfirdn2d as fir
from indm_tpu import ops as jax_ops
from indm_tpu.models import layers as jax_layers
from indm_tpu.ops.upfirdn2d_pallas import upfirdn2d_pallas
from torch_threads import one_torch_thread  # noqa: F401

FIR_K = [1, 3, 3, 1]
CASES = [
    # tests/test_ops.py:109-111
    (1, 1, (1, 2)), (1, 2, (2, 1)), (2, 1, (2, 1)),
    # the VE net: downsample_2d, conv_downsample_2d's FIR, upsample_conv_2d's
    (1, 2, (1, 1)), (1, 1, (2, 2)), (1, 1, (1, 1)),
]


def _x(shape=(2, 8, 8, 3), seed=7):
  return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _nchw(a):
  return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
  return t.permute(0, 2, 3, 1).numpy()


def test_setup_kernel_matches_jax():
  np.testing.assert_array_equal(fir.setup_kernel(FIR_K),
                                jax_ops.setup_kernel(FIR_K))
  np.testing.assert_array_equal(fir.setup_kernel(np.ones((3, 3))),
                                jax_ops.setup_kernel(np.ones((3, 3))))


@pytest.mark.parametrize("up,down,pad", CASES)
def test_upfirdn2d_plain_matches_native_and_interpret_kernel(up, down, pad):
  x = _x()
  k = jax_ops.setup_kernel(FIR_K)
  native = np.asarray(jax_ops.upfirdn2d_native(
      jnp.asarray(x), jnp.asarray(k), up, up, down, down, pad[0], pad[1],
      pad[0], pad[1]))
  pallas = np.asarray(upfirdn2d_pallas(jnp.asarray(x), jnp.asarray(k),
                                       up=up, down=down, pad=pad,
                                       interpret=True))
  before = fir.launches
  ours = _nhwc(fir.upfirdn2d(_nchw(x), k, up, down, pad))
  assert fir.launches == before  # a CPU tensor takes the plain version
  assert ours.shape == native.shape == pallas.shape
  np.testing.assert_allclose(ours, native, atol=1e-5)
  np.testing.assert_allclose(ours, pallas, atol=1e-5)


def test_upfirdn2d_plain_general_kernel():
  """A 2-D kernel that is not separable, not square, with up and down both
  2: the port's plain version takes any kernel, as the native oracle."""
  x = _x((2, 7, 9, 3), seed=1)
  k = np.random.default_rng(2).normal(size=(5, 3)).astype(np.float32)
  native = np.asarray(jax_ops.upfirdn2d_native(
      jnp.asarray(x), jnp.asarray(k), 2, 2, 2, 2, 3, 0, 3, 0))
  ours = _nhwc(fir.upfirdn2d_plain(_nchw(x), k, 2, 2, (3, 0)))
  np.testing.assert_allclose(ours, native, atol=1e-5)


@pytest.mark.parametrize("name", ["upsample_2d", "downsample_2d"])
def test_resampling_matches_jax(name):
  x = _x()
  want = np.asarray(getattr(jax_ops, name)(jnp.asarray(x), FIR_K, factor=2))
  got = _nhwc(getattr(fir, name)(_nchw(x), FIR_K, factor=2))
  assert got.shape == want.shape
  np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("name", ["upsample_conv_2d", "conv_downsample_2d"])
def test_conv_resampling_matches_jax(name):
  """The fused conv resamplers with a 3x3 weight (HWIO -> OIHW); the
  transposed conv follows the JAX package's dilated-conv semantics."""
  x = _x()
  w = np.random.default_rng(3).normal(size=(3, 3, 3, 5)).astype(np.float32)
  want = np.asarray(getattr(jax_ops, name)(jnp.asarray(x), jnp.asarray(w),
                                           k=FIR_K))
  w_t = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
  got = _nhwc(getattr(fir, name)(_nchw(x), w_t, k=FIR_K))
  assert got.shape == want.shape
  np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("layer,with_conv", [
    ("Upsample", False), ("Upsample", True), ("Downsample", False),
    ("Downsample", True), ("FIRConv2d", True)])
def test_fir_layers_match_jax(layer, with_conv):
  """The FIR resampling blocks (with and without their FIR conv) and the
  FIR conv without resampling, the JAX layer's weight carried across
  (HWIO -> OIHW) under the reference's `Conv2d_0`."""
  x = _x((2, 8, 8, 4))
  if layer == "FIRConv2d":
    j_mod = jax_layers.FIRConv2d(5, resample_kernel=FIR_K)
    t_mod = torch_layers.FIRConv2d(4, 5, resample_kernel=FIR_K)
  else:
    j_mod = getattr(jax_layers, layer)(out_ch=5 if with_conv else None,
                                       with_conv=with_conv, fir=True,
                                       fir_kernel=FIR_K)
    t_mod = getattr(torch_layers, layer)(4, 5 if with_conv else None,
                                         with_conv=with_conv,
                                         fir_kernel=FIR_K)
  variables = j_mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
  want = np.asarray(j_mod.apply(variables, jnp.asarray(x)))
  if with_conv:
    p = variables["params"]
    p = p if layer == "FIRConv2d" else p["FIRConv2d_0"]
    conv = t_mod if layer == "FIRConv2d" else t_mod.Conv2d_0
    # a bias that is not zero, so that it is checked too
    bias = np.linspace(-1, 1, 5, dtype=np.float32)
    want = want + bias
    conv.load_state_dict({
        "weight": torch.from_numpy(np.ascontiguousarray(
            np.asarray(p["weight"]).transpose(3, 2, 0, 1))),
        "bias": torch.from_numpy(bias)})
  with torch.no_grad():
    got = _nhwc(t_mod(_nchw(x)))
  assert got.shape == want.shape
  np.testing.assert_allclose(got, want, atol=1e-5)
