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

The `wgmma` route (`lipnet_wgmma`: every float32 product with a weight
fixed for the call, in kernels 3, 5, 7 and 8) has its own cases: its plain
once-a-call weight split (`weight_planes_plain`, the planes the kernel
makes: TF32 hi and lo in a k order permuted in groups of 8), an emulation
of the kernel's transposed 3xTF32 product built from those planes, that
emulation carried through a Neumann chain of eight terms, its refusals,
and the scratch sizes of kernels 3, 5 and 7 (which hold the planes)
against the formulas in the sources' comments.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch.nn.functional as F

from indm_torch.flows.resflow import OFFSET_TRAIN, RCDF_TRAIN
from indm_torch.ops import fused_block as fb
from indm_torch.ops import fused_stack as fs
from indm_torch.ops import lipnet_gemm as lg
from indm_torch.ops import neumann
from indm_tpu.ops.fused_block import _wgrad
from indm_tpu.ops.neumann_pallas import _apply_packed
from torch_threads import one_torch_thread  # noqa: F401

# float32 sums of up to a few hundred products in another order than the
# float64 reference: 1e-5 of the largest value, as the card tests hold the
# kernel
RTOL = 1e-5
# a chain against its plain version: float32 sums in another order over up
# to 4608 products a term, 1e-4 of the largest value (chip_smoke.py's
# CHAIN_RTOL, the card's tolerance of kernels 7 and 8)
CHAIN_RTOL = 1e-4
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


# ---- the forward's wgmma route ----


@pytest.mark.parametrize("shape", [(64, 512), (20, 36), (3, 12)])
def test_weight_planes_split_once_a_call(shape):
  """`weight_planes_plain`: hi has its 13 low mantissa bits clear and is x
  rounded to nearest, ties away from zero (the card's `rna_tf32`, as the
  numpy emulation `_tf32` rounds); lo is TF32 too; hi + lo is within 2^-22
  of x relative to |x|; the columns follow `k_order`, zero past K."""
  m, k = shape
  rng = np.random.default_rng(4)
  w = _randn(rng, m, k) * np.float32(3.0)
  planes = lg.weight_planes_plain(torch.from_numpy(w)).numpy()
  kp = -(-k // 8) * 8
  assert planes.shape == (2, m, kp) and planes.dtype == np.float32
  hi, lo = planes
  for part in (hi, lo):
    assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
  order = lg.k_order(k).numpy()
  assert sorted(order[order >= 0]) == list(range(k))
  assert not hi[:, order < 0].any() and not lo[:, order < 0].any()
  x = w[:, order[order >= 0]]
  hi, lo = hi[:, order >= 0], lo[:, order >= 0]
  assert np.array_equal(hi, _tf32(x))
  err = np.abs(hi.astype(np.float64) + lo - x)
  assert (err <= 2.0 ** -22 * np.abs(x)).all(), (err / np.abs(x)).max()


def test_weight_split_rounds_ties_away():
  """The split's hi on chosen bits: below, at and above half of the dropped
  13 bits, for both signs (the tie rounds away from zero)."""
  one = np.float32(1.0).view(np.uint32)
  for delta, up in ((0x0FFF, False), (0x1000, True), (0x1001, True)):
    for sign in (1, -1):
      x = np.array([[one + delta] * 8], np.uint32).view(np.float32) * sign
      hi = lg.weight_planes_plain(torch.from_numpy(x))[0].numpy()
      assert (hi == np.float32(sign * (1.0 + 2.0 ** -10 if up else 1.0))).all()


def _emulate_wgmma(w, act):
  """The kernel's arithmetic in numpy: D[p, m] = sum_k A[p, k] B[k, m] with
  A = act^T split in registers (hi, lo = tf32, tf32 of the rest) and B the
  weight's planes; the activation rows gathered in the planes' k order (a
  thread's fragment reads rows 2t and 2t + 1); each k-tile of 32 summed
  from a_lo b_hi + a_hi b_lo + a_hi b_hi in float32 into a fresh part,
  added to the total in float32."""
  m, k = w.shape
  planes = lg.weight_planes_plain(torch.from_numpy(w)).numpy()
  order = lg.k_order(k).numpy()
  out = np.zeros((act.shape[0], act.shape[2], m), np.float32)
  for s, sample in enumerate(act):
    a = np.zeros((sample.shape[1], order.size), np.float32)
    a[:, order >= 0] = sample.T[:, order[order >= 0]]
    a_hi = _tf32(a)
    a_lo = _tf32(a - a_hi)
    for k0 in range(0, order.size, 32):
      sl = slice(k0, k0 + 32)
      b_hi, b_lo = planes[0][:, sl].T, planes[1][:, sl].T
      part = a_lo[:, sl] @ b_hi + a_hi[:, sl] @ b_lo + a_hi[:, sl] @ b_hi
      out[s] += part
  return out.transpose(0, 2, 1)


@pytest.mark.parametrize("depth", [512, 36])
def test_transposed_3xtf32_emulation_keeps_the_float32_contract(depth):
  """The emulation of the wgmma route's transposed product at the forward's
  depth (and a ragged one) against the float64 product: within 1e-5 of the
  largest output, the float32 contract; so does the wrapper's CPU
  route."""
  rng = np.random.default_rng(5)
  w = _randn(rng, 40, depth) / np.float32(np.sqrt(depth))
  act = _randn(rng, 2, depth, 24)
  exact = np.matmul(w.astype(np.float64), act.astype(np.float64))
  _assert_close_to_scale(_emulate_wgmma(w, act), exact)
  got = lg.lipnet_wgmma(torch.from_numpy(w), torch.from_numpy(act))
  _assert_close_to_scale(got.numpy(), exact)


def _emulate_one_tf32(w, act):
  """One TF32 product, tf32(w) @ tf32(act[s]) in float32: the control."""
  return np.stack([_tf32(w) @ _tf32(a) for a in act])


def _emulated_chain(vareps, dacts, weights_t, coeffs, product):
  """Kernel 7's float32 chain with each term's 1x1 product W1^T t1 through
  `product` (numpy, [M, K] and [B, K, N]); the narrow convs in float32
  `F.conv2d`, each diagonal product and acc += coeff * v in float32."""
  w_in, w_mid, w_out = weights_t
  v, acc = vareps, torch.zeros_like(vareps)
  for coeff in coeffs:
    t1 = F.conv2d(v, w_in, padding=1) * dacts[0]
    b, i, h, w = t1.shape
    t2 = torch.from_numpy(product(w_mid[:, :, 0, 0].numpy(),
                                  t1.reshape(b, i, h * w).numpy()))
    v = F.conv2d(t2.reshape(b, i, h, w) * dacts[1], w_out, padding=1)
    if len(dacts) == 3:
      v = v * dacts[2]
    acc = acc + float(coeff) * v
  return acc


@pytest.mark.parametrize("geom", [(3, 8, 128, True), (12, 4, 512, False)])
def test_chain_of_wgmma_products_keeps_the_chain_tolerance(geom):
  """The error of the `wgmma` route carried over a chain: n + 2 = 8 terms
  of kernel 7's float32 chain (weights of variance 1 / fan_in, diagonals
  cos 2 pi a, so that every term is of order one), each term's product
  through `_emulate_wgmma` on W1^T's planes, against `neumann_chain_plain`
  on the same inputs in float64 (every sum exact): within CHAIN_RTOL of
  the largest value. With one TF32 product a term the chain misses it."""
  c, hw, idim, preact = geom
  rng = np.random.default_rng(7)
  t = lambda *s: torch.from_numpy(_randn(rng, *s))  # noqa: E731
  weights_t = [t(*s) / np.float32(np.sqrt(np.prod(s[1:])))
               for s in ((idim, c, 3, 3), (idim, idim, 1, 1),
                         (c, idim, 3, 3))]
  dacts = [torch.cos(2 * np.pi * t(2, idim, hw, hw)) for _ in range(2)]
  if preact:
    dacts.append(torch.cos(2 * np.pi * t(2, c, hw, hw)))
  vareps = t(2, c, hw, hw)
  n = 6
  coeffs = neumann.chain_coeffs(n, OFFSET_TRAIN, RCDF_TRAIN)
  assert len(coeffs) == 8
  exact = neumann.neumann_chain_plain(
      vareps.double(), [d.double() for d in dacts],
      [w.double() for w in weights_t], n, OFFSET_TRAIN, RCDF_TRAIN,
      torch.float32)
  _assert_close_to_scale(
      _emulated_chain(vareps, dacts, weights_t, coeffs, _emulate_wgmma),
      exact, CHAIN_RTOL)
  one = _emulated_chain(vareps, dacts, weights_t, coeffs, _emulate_one_tf32)
  assert (one.double() - exact).abs().max() > CHAIN_RTOL * exact.abs().max()


def test_wgmma_route_matches_jax_apply_packed():
  """`_apply_packed(x, w, "mat")` on an NHWC tile against the wgmma route's
  w^T @ x per sample in NCHW (its plain version on the CPU)."""
  b, cin, cout, hw = 2, 64, 48, 8
  rng = np.random.default_rng(6)
  x = _randn(rng, b, hw, hw, cin)
  w = _randn(rng, cin, cout) / np.float32(np.sqrt(cin))
  want = np.asarray(_apply_packed(jnp.asarray(x), jnp.asarray(w), "mat",
                                  jnp.float32))
  act = torch.from_numpy(np.ascontiguousarray(
      x.transpose(0, 3, 1, 2).reshape(b, cin, hw * hw)))
  got = lg.lipnet_wgmma(torch.from_numpy(np.ascontiguousarray(w.T)), act)
  _assert_close_to_scale(
      got.numpy().reshape(b, cout, hw, hw).transpose(0, 2, 3, 1), want)


def _wgmma_refused(case):
  t = lambda *s: torch.zeros(s)  # noqa: E731
  return {
      "K not a multiple of 4": (t(8, 6), t(B, 6, 8)),
      "N not a multiple of 4": (t(8, 8), t(B, 8, 6)),
      "float64": (t(8, 8).double(), t(B, 8, 8).double()),
      "not contiguous": (t(8, 8).t(), t(B, 8, 8).transpose(1, 2)),
      "batched weight": (t(B, 8, 8), t(B, 8, 8)),
      "no batch": (t(8, 8), t(8, 8)),
      "K disagrees": (t(8, 8), t(B, 4, 8)),
      "empty batch": (t(8, 8), t(0, 8, 8)),
  }[case]


@pytest.mark.parametrize("case", [
    "K not a multiple of 4", "N not a multiple of 4", "float64",
    "not contiguous", "batched weight", "no batch", "K disagrees",
    "empty batch"])
def test_wgmma_wrapper_refuses_what_the_kernel_does_not_take(case):
  before = lg.wgmma_launches
  with pytest.raises(ValueError):
    lg.lipnet_wgmma(*_wgmma_refused(case))
  assert lg.wgmma_launches == before


CSRC = Path(lg.__file__).resolve().parents[1] / "csrc"


def _comment_formula(source, start, end):
  """The expression after "scratch: at least" in the comment between
  `start` and `end` of csrc/<source>."""
  text = (CSRC / source).read_text()
  block = text[text.index(start):text.index(end)]
  block = " ".join(line.strip().lstrip("/").strip()
                   for line in block.splitlines())
  return re.search(r"scratch: at least (.*?) floats", block).group(1)


@pytest.mark.parametrize("geom", [(128, 3, 32, 512, 15), (128, 12, 16, 512, 16),
                                  (2, 12, 8, 36, 2), (3, 3, 16, 132, 3)])
def test_forward_scratch_sizes_match_the_sources(geom):
  """Kernel 3's and kernel 5's scratch floats (`fwd_scratch_floats` of both
  wrappers), which now hold W1's and W1^T's planes, against the formulas
  in the entry points' comments (I8 = I rounded up to a multiple of 8) and
  in `fused_block_ops.cuh`'s (the planes and the temporaries)."""
  b, c, hw, idim, nb = geom
  names = dict(B=b, C=c, H=hw, W=hw, I=idim, I8=-(-idim // 8) * 8, n=nb)
  k3 = _comment_formula("fused_block.cu", "// Kernel 3.",
                        "int indm_fused_block_fwd")
  k5 = _comment_formula("fused_stack.cu", "// Kernel 5.",
                        "int indm_fused_stack_fwd")
  assert eval(k3, {}, names) == fb.fwd_scratch_floats(b, c, hw * hw, idim)
  assert eval(k5, {}, names) == fs.fwd_scratch_floats(nb, b, c, hw * hw,
                                                      idim)
  header = (CSRC / "fused_block_ops.cuh").read_text()
  temps = re.search(r"fwd's temporaries: (.*?) floats", header).group(1)
  planes = re.search(r"split_weights\), (.*?) floats", header).group(1)
  assert eval(planes, {}, names) == fb.plane_floats(idim)
  assert (eval(temps, {}, names) + fb.plane_floats(idim)
          == fb.fwd_scratch_floats(b, c, hw * hw, idim))


@pytest.mark.parametrize("idim", [512, 132, 36, 8])
def test_chain_planes_match_the_source(idim):
  """Kernel 7's float32 scratch for W1^T's planes (`chain_plane_floats`,
  which the wrapper allocates) against the formula in the comment of
  `csrc/neumann_chain.cu`'s entry point (I8 = I rounded up to 8) and the
  planes `weight_planes_plain` makes of an [I, I] weight."""
  text = (CSRC / "neumann_chain.cu").read_text()
  block = text[text.index("extern \"C\""):text.index("int indm_neumann_chain(")]
  block = " ".join(line.strip().lstrip("/").strip()
                   for line in block.splitlines())
  formula = re.search(r"W1\^T's TF32 planes: (.*?) floats", block).group(1)
  names = dict(I=idim, I8=-(-idim // 8) * 8)
  assert eval(formula, {}, names) == neumann.chain_plane_floats(idim)
  assert lg.weight_planes_plain(torch.zeros(idim, idim)).numel() == (
      neumann.chain_plane_floats(idim))
