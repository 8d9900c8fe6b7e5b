"""The Lipschitz net's 512-wide product alone (`indm_torch.ops.lipnet_gemm`)
against numpy's float64 product and the JAX package's in-kernel products.

On these CPU tensors the wrapper takes its plain version; the CUDA kernel
is held against a float64 product on the card by `test_torch_cuda.py` and
`chip_smoke.py`. The JAX side is `_apply_packed(..., "mat")` of
`indm_tpu/ops/neumann_pallas.py` (the 1x1 conv of a [pixels, channels]
tile) and `_wgrad` of `indm_tpu/ops/fused_block.py` (a weight gradient
contracted over pixels), on the same numpy inputs. The last test states
why the kernel splits each operand into two TF32 values: with one, a
product of depth 512 misses the float32 contract.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indm_torch.ops import lipnet_gemm as lg
from indm_tpu.ops.fused_block import _wgrad
from indm_tpu.ops.neumann_pallas import _apply_packed
from torch_threads import one_torch_thread  # noqa: F401

# float32 sums of up to a few hundred products in another order than the
# float64 reference: 1e-5 of the largest value, as the card tests hold the
# kernel
RTOL = 1e-5
B, M, N, K = 3, 20, 12, 36   # ragged against the kernel's 128 x 128 tile


def _randn(rng, *shape):
  return rng.standard_normal(shape).astype(np.float32)


def _assert_close_to_scale(got, want, tol=RTOL):
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  assert got.shape == want.shape
  big = np.abs(want).max()
  assert np.abs(got - want).max() <= tol * big, (
      np.abs(got - want).max(), big)


@pytest.mark.parametrize("shared", ["none", "a", "b"])
@pytest.mark.parametrize("npairs", [1, 2])
@pytest.mark.parametrize("bt", [False, True])
def test_plain_matches_float64(bt, npairs, shared):
  """Both layouts, one and two pairs, with a batched or a shared (2-D)
  operand, against numpy's float64 product."""
  rng = np.random.default_rng(0)
  a_shape = (M, K) if shared == "a" else (B, M, K)
  b_core = (N, K) if bt else (K, N)
  b_shape = b_core if shared == "b" else (B,) + b_core
  pairs = [(_randn(rng, *a_shape), _randn(rng, *b_shape))
           for _ in range(npairs)]
  want = sum(np.matmul(a.astype(np.float64),
                       np.swapaxes(b, -1, -2).astype(np.float64) if bt
                       else b.astype(np.float64))
             for a, b in pairs)
  got = lg.lipnet_gemm([(torch.from_numpy(a), torch.from_numpy(b))
                        for a, b in pairs], bt=bt)
  assert got.dtype == torch.float32 and tuple(got.shape) == (B, M, N)
  _assert_close_to_scale(got.numpy(), want)


@pytest.mark.parametrize("geom", [(2, 64, 64, 8), (3, 64, 32, 4)])
def test_mat_matches_jax_apply_packed(geom):
  """`_apply_packed(x, w, "mat")` on an NHWC tile against the port's
  per-sample product w^T @ x in NCHW, the layout `mat_wide` takes."""
  b, cin, cout, hw = geom
  rng = np.random.default_rng(1)
  x = _randn(rng, b, hw, hw, cin)
  w = _randn(rng, cin, cout) / np.float32(np.sqrt(cin))
  want = np.asarray(_apply_packed(jnp.asarray(x), jnp.asarray(w), "mat",
                                  jnp.float32))
  x_nchw = torch.from_numpy(np.ascontiguousarray(
      x.transpose(0, 3, 1, 2).reshape(b, cin, hw * hw)))
  got = lg.lipnet_gemm([(torch.from_numpy(np.ascontiguousarray(w.T)),
                         x_nchw)])
  got = got.numpy().reshape(b, cout, hw, hw).transpose(0, 2, 3, 1)
  _assert_close_to_scale(got, want)


def test_weight_gradient_pair_matches_jax_wgrad():
  """The w1 gradient of the fused backward, `_wgrad(s1, z2b) +
  _wgrad(t1, a2b)` over the batch's pixels ([I_in, I_out]), against the
  port's two-pair bt product per sample (z2b @ s1^T + a2b @ t1^T,
  [I_out, I_in]) summed over the batch."""
  b, width, hw = 2, 32, 8
  rng = np.random.default_rng(2)
  s1, z2b, t1, a2b = (_randn(rng, b, hw, hw, width) for _ in range(4))
  flat = lambda t: jnp.asarray(t.reshape(-1, width))  # noqa: E731
  want = np.asarray(_wgrad(flat(s1), flat(z2b)) + _wgrad(flat(t1),
                                                          flat(a2b)))

  def nchw(t):
    return torch.from_numpy(np.ascontiguousarray(
        t.transpose(0, 3, 1, 2).reshape(b, width, hw * hw)))

  got = lg.lipnet_gemm([(nchw(z2b), nchw(s1)), (nchw(a2b), nchw(t1))],
                       bt=True)
  assert tuple(got.shape) == (b, width, width)
  _assert_close_to_scale(got.sum(0).numpy().T, want)


def _refused(case):
  """An input the kernel does not take, and its pairs and layout."""
  t = lambda *s: torch.zeros(s)  # noqa: E731
  return {
      "K not a multiple of 4": ([(t(B, 8, 6), t(B, 6, 8))], False),
      "N not a multiple of 4": ([(t(B, 8, 8), t(B, 8, 6))], False),
      "N not a multiple of 4, bt": ([(t(B, 8, 8), t(B, 6, 8))], True),
      "float64": ([(t(B, 8, 8).double(), t(B, 8, 8).double())], False),
      "bfloat16": ([(t(B, 8, 8), t(B, 8, 8).bfloat16())], False),
      "not contiguous": ([(t(B, 8, 8).transpose(1, 2), t(B, 8, 8))], False),
      "three pairs": ([(t(B, 8, 8), t(B, 8, 8))] * 3, False),
      "pairs of other shapes": ([(t(B, 8, 8), t(B, 8, 8)),
                                 (t(B, 8, 4), t(B, 4, 8))], False),
      "no batch": ([(t(8, 8), t(8, 8))], False),
      "K disagrees": ([(t(B, 8, 8), t(B, 4, 8))], False),
      "batches disagree": ([(t(B, 8, 8), t(B + 1, 8, 8))], False),
  }[case]


@pytest.mark.parametrize("case", [
    "K not a multiple of 4", "N not a multiple of 4",
    "N not a multiple of 4, bt", "float64", "bfloat16", "not contiguous",
    "three pairs", "pairs of other shapes", "no batch", "K disagrees",
    "batches disagree"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
  pairs, bt = _refused(case)
  with pytest.raises(ValueError):
    lg.lipnet_gemm(pairs, bt=bt)


def _tf32(x):
  """x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero,
  as `cvt.rna.tf32.f32` rounds: add half of the dropped 13 bits to the
  magnitude, then clear them."""
  u = np.ascontiguousarray(x, np.float32).view(np.uint32)
  return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.mark.parametrize("depth", [256, 512, 1024])
def test_3xtf32_keeps_the_float32_contract_where_tf32_does_not(depth):
  """A plain emulation of the kernel's arithmetic at the main path's
  depths: each operand split into hi = tf32(x) and lo = tf32(x - hi), the
  product a_lo b_hi + a_hi b_lo + a_hi b_hi accumulated in float32. It
  stays within the card tests' 1e-5 of the float64 product's largest
  value; one TF32 product, tf32(a) tf32(b), does not."""
  rng = np.random.default_rng(3)
  a = _randn(rng, 64, depth) / np.float32(np.sqrt(depth))
  b = _randn(rng, depth, 64)
  exact = a.astype(np.float64) @ b.astype(np.float64)
  a_hi, b_hi = _tf32(a), _tf32(b)
  a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
  assert np.array_equal(_tf32(a_hi), a_hi) and np.array_equal(_tf32(a_lo),
                                                              a_lo)
  three = a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi   # float32 sums
  one = a_hi @ b_hi
  big = np.abs(exact).max()
  err3 = np.abs(three - exact).max() / big
  err1 = np.abs(one - exact).max() / big
  assert err3 <= RTOL, err3
  assert err1 > RTOL, err1
  assert err1 > 30 * err3, (err1, err3)


def test_tf32_rounding_is_nearest_ties_away():
  """The emulation's rounding on chosen bits: below, at and above half of
  the dropped 13 bits, for both signs."""
  one = np.float32(1.0).view(np.uint32)
  for delta, up in ((0x0FFF, False), (0x1000, True), (0x1001, True)):
    for sign in (1, -1):
      x = np.array([one + delta], np.uint32).view(np.float32) * sign
      want = sign * (1.0 + 2.0 ** -10 if up else 1.0)
      assert _tf32(x)[0] == np.float32(want)
