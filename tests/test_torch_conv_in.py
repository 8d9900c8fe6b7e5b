"""conv_in's arithmetic (the Lipschitz net's C -> I conv, an implicit GEMM
on the tensor cores in `indm_torch/csrc/lipnet_ops.cuh`) held to its
contract where no card is present, through `narrow_conv.conv_in_emulated`.

float32: 3xTF32 keeps the float32 contract at both flow scales (C = 3 and
12) where one TF32 product does not. bfloat16: exact products and float32
sums, against the JAX package's `_apply_packed(kind="narrow_in")`
(`indm_tpu/ops/neumann_pallas.py:97-111`, with `jnp.roll` off the TPU).
Last, the new kernels' tile and shared-memory constants, read from the
sources, fit an SM and match what the Python side assumes. The kernels
themselves are held against these on the card by `test_torch_cuda.py` and
`chip_smoke.py`.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from indm_torch.ops import lipnet_gemm as lg
from indm_torch.ops import narrow_conv as nc
from indm_tpu.ops.neumann_pallas import _apply_packed
from torch_threads import one_torch_thread  # noqa: F401

CSRC = Path(nc.__file__).resolve().parents[1] / "csrc"
SMEM = 232448  # shared memory a block can use on an H100
# the float32 contract, as the card holds the GEMMs (GEMM_RTOL)
RTOL = 1e-5


def _inputs(c, idim, hw, seed, dtype=torch.float32):
  """x [2, c, hw, hw] of variance 1 and w [idim, c, 3, 3] of variance
  1 / (9 c), from numpy."""
  rng = np.random.default_rng(seed)
  x = rng.standard_normal((2, c, hw, hw)).astype(np.float32)
  w = (rng.standard_normal((idim, c, 3, 3)) / np.sqrt(9 * c)).astype(
      np.float32)
  return torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype)


@pytest.mark.parametrize("c, hw", [(3, 16), (12, 8)])
def test_3xtf32_keeps_the_float32_contract_where_tf32_does_not(c, hw):
  """The float32 route: im2col with K padded, both operands split into
  TF32 hi and lo, the small terms first, a fresh sum per 32 of K. It stays
  within 1e-5 of the float64 convolution's largest value; one TF32 pass,
  tf32(w) * tf32(x), does not."""
  x, w = _inputs(c, 64, hw, seed=c)
  exact = F.conv2d(x.double(), w.double(), padding=1)
  big = exact.abs().max().item()
  got = nc.conv_in_emulated(x, w)
  assert got.dtype == torch.float32 and got.shape == exact.shape
  err3 = (got.double() - exact).abs().max().item() / big
  one = F.conv2d(lg.tf32(x).double(), lg.tf32(w).double(), padding=1)
  err1 = (one.float().double() - exact).abs().max().item() / big
  assert err3 <= RTOL, err3
  assert err1 > RTOL, err1
  assert err1 > 30 * err3, (err1, err3)


@pytest.mark.parametrize("c", [3, 12])
def test_bf16_route_matches_jax_narrow_in(c):
  """The bfloat16 route (exact products, float32 sums, a fresh sum per 32
  of K) against `_apply_packed(x, w, "narrow_in")` on the same bfloat16
  values in NHWC: their float32 sums within 1e-5 of the largest value
  (sums of the same exact products in another order), and both rounded to
  bfloat16 within 1e-2 of it (tests/test_torch_narrow_conv.py's bfloat16
  tolerance: one rounding, one bfloat16 step apart at most)."""
  x, w = _inputs(c, 64, 8, seed=10 + c, dtype=torch.bfloat16)
  x_nhwc = jnp.asarray(x.float().permute(0, 2, 3, 1).numpy(), jnp.bfloat16)
  # HWIO rows (tap, c): the packing of `_pack_weight`
  wmat = jnp.asarray(w.float().permute(2, 3, 1, 0).reshape(9 * c, -1)
                     .numpy(), jnp.bfloat16)
  want = np.asarray(_apply_packed(x_nhwc, wmat, "narrow_in", jnp.float32,
                                  in_kernel=False), np.float32)
  want = torch.from_numpy(want.copy()).permute(0, 3, 1, 2)
  got = nc.conv_in_emulated(x, w)
  big = want.abs().max().item()
  assert (got - want).abs().max().item() <= RTOL * big
  assert ((got.bfloat16().float() - want.bfloat16().float()).abs().max()
          .item() <= 1e-2 * big)
  assert torch.equal(got.bfloat16(), nc.narrow_conv(x, w))


def _constants(source):
  """{name: value} of the namespace-level `constexpr int k... = <sum or
  product of integers and earlier such constants>;` lines of
  csrc/<source>."""
  out = {}
  for m in re.finditer(r"^constexpr int (k\w+) = ([\w\s+*/()-]+);",
                       (CSRC / source).read_text(), re.MULTILINE):
    try:
      out[m.group(1)] = int(eval(m.group(2).replace("/", "//"), {},
                                 dict(out)))
    except NameError:  # names a constant of another form
      pass
  return out


@pytest.mark.parametrize("c", [3, 12])
def test_conv_in_tiles_fit_and_match_the_python_side(c):
  """InTile's sizes, from the source's constants and formulas: K padded
  as `padded_depth` says, rows padded for conflict-free fragment loads,
  every (C, type) within an SM's shared memory, two weight tiles (the
  cp.async path) exactly for bfloat16 rows of whole words. The tile is
  the 128 pixels of `Geometry` (th * tw for tw = 8, 16, 32), its halo
  within kMaxHalo."""
  k = _constants("lipnet_ops.cuh")
  text = (CSRC / "lipnet_ops.cuh").read_text()
  # multiples of 16 in bfloat16 and of 8 in float32: the same K at 3 and 12
  assert "KP = kBf16 ? (KC + 15) / 16 * 16 : (KC + 7) / 8 * 8" in text
  assert (9 * c + 15) // 16 * 16 == (9 * c + 7) // 8 * 8
  assert "S = kBf16 ? KP + 8 : KP + 4" in text
  assert "kb += 32" in text and nc.K_TILE == 32
  pixels, chunk, halo = k["kConvPixels"], k["kOcChunk"], k["kMaxHalo"]
  assert k["kConvThreads"] == 2 * pixels == 256
  for tw in (8, 16, 32):
    assert (pixels // tw + 2) * (tw + 2) <= halo
  kc, kp = 9 * c, nc.padded_depth(c)
  assert kp == (kc + 15) // 16 * 16 and kp % 16 == 0 and kp >= kc
  staging = chunk * (pixels + 8) * 4
  for bf16 in (False, True):
    elem, planes = (2, 1) if bf16 else (4, 2)
    s = kp + 8 if bf16 else kp + 4
    if bf16:
      assert s * 2 % 16 == 0 and s * 2 // 16 % 2 == 1  # ldmatrix rows
    else:
      assert s % 32 % 8 == 4  # 4-byte fragment loads on 32 banks
    bufs = 2 if bf16 and kc % 2 == 0 else 1
    smem = (planes * pixels * s * elem + bufs * planes * chunk * s * elem
            + max(staging, c * halo * 4))
    assert smem <= SMEM, (c, bf16, smem)
  # the weight chunk's 4-byte copies need whole words a row
  assert (kc % 2 == 0) == (c == 12)
  assert "kAsync = kBf16 && KC % 2 == 0" in text
  assert "kWBufs = kAsync ? 2 : 1" in text


def test_conv_in_48_channel_groups_fit():
  """conv_in at 48 channels (float32, kernel 7 at CelebA's second flow
  scale): K in six groups of 8 channels, K = 72 a group with no pad, rows
  padded for conflict-free fragment loads; the group's im2col and weight
  tiles in TF32 planes, the staging and the 48-channel halo beside it
  within an SM's shared memory; a quarter of a weight row a thread."""
  k = _constants("lipnet_ops.cuh")
  text = (CSRC / "lipnet_ops.cuh").read_text()
  assert "CG = C > 12 ? 8 : C" in text
  assert "kGroups > 1 ? kConvStaging + kHaloBytes" in text
  pixels, chunk, halo = k["kConvPixels"], k["kOcChunk"], k["kMaxHalo"]
  cg = 8
  kc = 9 * cg
  kp = (kc + 7) // 8 * 8
  s = kp + 4
  assert 48 % cg == 0 and kp == kc == 72 and s % 32 % 8 == 4
  assert kp // 2 % 9 == 0  # a thread's half row holds whole channels
  smem = (2 * pixels * s * 4 + 2 * chunk * s * 4
          + chunk * (pixels + 8) * 4 + 48 * halo * 4)
  assert smem == 190720 <= SMEM
  assert chunk * 4 == k["kConvThreads"] and kc % 4 == 0


def test_bf16_gemm_tiles_fit_and_match_the_python_side():
  """The bfloat16 `wgmma` GEMM's ring and staging fit an SM; a stage's
  rows are the 128 bytes of the TMA swizzle; the wrapper's K and N
  multiples of 8 are TMA's 16-byte strides; the fresh accumulator is 32
  of K, half a stage."""
  k = _constants("lipnet_wgmma_bf16.cuh")
  assert k["kXK"] * 2 == 128 and k["kXK"] == 2 * k["kXKTile"] == 64
  assert k["kXStageRow"] % 32 == 8
  smem = (1024 + k["kXStages"] * (k["kXM"] + k["kXN"]) * k["kXK"] * 2
          + 2 * 64 * k["kXStageRow"] * 4 + 2 * k["kXStages"] * 8)
  assert smem <= SMEM
  a = torch.zeros(2, 16, 12, dtype=torch.bfloat16)
  with pytest.raises(ValueError, match="multiples of 8"):
    lg.lipnet_gemm_bf16([(a, torch.zeros(2, 12, 16, dtype=torch.bfloat16))])
  out = lg.lipnet_gemm_bf16([(torch.zeros(2, 16, 8, dtype=torch.bfloat16),
                              torch.zeros(2, 8, 16, dtype=torch.bfloat16))])
  assert out.dtype == torch.float32 and tuple(out.shape) == (2, 16, 16)
