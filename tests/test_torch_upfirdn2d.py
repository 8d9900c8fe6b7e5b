"""The port's upfirdn2d (kernel 9's plain version, which a CPU tensor takes),
its four resampling functions and the FIR layers against the JAX package.

The plain version is held against the oracle `upfirdn2d_native` and the
TPU kernel in interpret mode at the three cases of `tests/test_ops.py`
and at the (up, down, pad) triples of the VE score net, with the JAX
test's own tolerance, atol 1e-5. Images are NHWC on the JAX side and
NCHW in the port; weights HWIO and OIHW.
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
from indm_torch.ops import upfirdn2d as fir
from indm_tpu import ops as jax_ops
from indm_tpu.models import layers as jax_layers
from indm_tpu.ops.upfirdn2d_pallas import _separate, upfirdn2d_pallas
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
                                         with_conv=with_conv, fir=True,
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


@pytest.mark.parametrize("gain", [4.0, 1.0])
def test_separate_matches_jax(gain):
  """The wrapper's tap factorisation against the TPU kernel's `_separate`
  (the same SVD, the same sign) for the kernels the net builds from its
  FIR kernel (1, 3, 3, 1): upsample_2d's and upsample_conv_2d's (gain
  factor ** 2 = 4), downsample_2d's and conv_downsample_2d's (gain 1);
  the outer product of the factors within 1e-7 of the kernel (0.75 is
  factored one float32 step high: 8.9e-8 at 0.5625)."""
  k = fir._fir((1, 3, 3, 1), 2, gain)
  np.testing.assert_array_equal(k, jax_ops.setup_kernel([1, 3, 3, 1]) * gain)
  col, row = fir.separate(k)
  want_col, want_row = _separate(k)
  np.testing.assert_array_equal(col, want_col)
  np.testing.assert_array_equal(row, want_row)
  # the factors' own error: their product taken exactly, in float64
  assert np.abs(np.outer(col.astype(np.float64), row) - k).max() <= 1e-7
  t = fir.taps(k)
  assert t is fir.taps(k.copy())  # factored once per distinct kernel
  assert t.col is not None and np.array_equal(t.k, k)


def test_separate_reports_a_kernel_that_is_not_separable():
  """A kernel of rank 2 has no factors: the wrapper reports None (and the
  card takes the tile kernel), where `_separate` raises."""
  k = np.random.default_rng(2).normal(size=(5, 3)).astype(np.float32)
  assert fir.separate(k) is None and fir.taps(k).col is None
  with pytest.raises(NotImplementedError):
    _separate(k)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a row of the whole-plane plan table in `upfirdn2d.cu`'s note
_PLAN_ROW = re.compile(r"^//\s+(\d+) x (\d+) x (\d+)\s+(\d)/(\d)\s+"
                       r"(\d+), (\d+)\s+(\d+)x(\d+)\s+(\d+)\s+(\d+)\s+"
                       r"([\d.]+)$", re.M)


def test_net_calls_match_the_plan_in_the_source(monkeypatch):
  """The full-width VE net's upfirdn2d calls (the wrapper wrapped, at batch
  1 on the CPU) against the table in `upfirdn2d.cu`'s note: the same
  (C, H, W, up, down, pad) with the same count, VE_FIR_PER_EVAL
  (chip_smoke.py) in all, every kernel separable; each row's output size,
  the wrapper's planes a block at batch 64 and the bound."""
  cs, seen = _net_calls("ve/CIFAR10/indm", monkeypatch)
  table = _PLAN_ROW.findall(open(os.path.join(
      REPO, "indm_torch", "csrc", "upfirdn2d.cu")).read().split(
          "At 64x64")[0])
  _check_plan_table(cs, seen, table, 0.115)


def test_64x64_net_calls_match_the_plan_in_the_source(monkeypatch):
  """The same for the 64x64 VE net (`ve/CELEBA/indm`) against the note's
  second table (after "At 64x64"): its 15 calls in 9 shapes, every one
  on the whole-plane kernel, 0.459 ms of bound an evaluation at batch
  64."""
  cs, seen = _net_calls("ve/CELEBA/indm", monkeypatch)
  table = _PLAN_ROW.findall(open(os.path.join(
      REPO, "indm_torch", "csrc", "upfirdn2d.cu")).read().split(
          "At 64x64")[1])
  _check_plan_table(cs, seen, table, 0.459)


def _net_calls(name, monkeypatch):
  """chip_smoke and {(C, H, W, up, down, pad0, pad1, taps): calls} of one
  forward of the full-width net of `name` at batch 1 on the CPU."""
  from indm_torch.configs import get_config
  from indm_torch.models.registry import create_model
  spec = importlib.util.spec_from_file_location(
      "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
  cs = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(cs)
  cfg = get_config(name)
  model = create_model(cfg, seed=0, device="cpu")
  seen = collections.Counter()
  kernel = fir.upfirdn2d

  def record(v, k, up=1, down=1, pad=(0, 0)):
    assert fir.taps(k).col is not None
    seen[(*v.shape[1:], up, down, *pad, k.shape[0])] += 1
    return kernel(v, k, up, down, pad)

  monkeypatch.setattr(fir, "upfirdn2d", record)
  size = cfg.data.image_size
  with torch.no_grad():
    model(torch.zeros(1, 3, size, size), torch.full((1,), 0.5))
  monkeypatch.undo()
  assert sum(seen.values()) == cs.VE_FIR_PER_EVAL == 15
  return cs, seen


def _check_plan_table(cs, seen, table, total_ms):
  """Each row of `table` against the calls `seen`: the count, the output
  size, the wrapper's planes a block at batch 64 and the bound; the sum of
  the bounds, `total_ms`."""
  assert len(table) == len(seen) == 9
  total = 0.0
  for row in table:
    c, h, w, up, down, p0, p1, oh, ow, calls, ppb, bound = (
        [int(v) for v in row[:-1]] + [float(row[-1])])
    assert seen[(c, h, w, up, down, p0, p1, 4)] == calls, row
    assert (oh, ow) == (fir.out_size(h, 4, up, down, (p0, p1)),
                        fir.out_size(w, 4, up, down, (p0, p1)))
    assert fir.plane_plan(cs.BATCH * c, h, w, oh, ow) == ppb
    us = 4 * cs.BATCH * c * (h * w + oh * ow) / cs.HBM_BYTES_PER_S * 1e6
    assert abs(us - bound) <= 0.005, (row, us)
    total += calls * us
  assert abs(total / 1e3 - total_ms) < 5e-4


@pytest.mark.parametrize("p,h,w,oh,ow,want", [
    (16384, 16, 16, 32, 32, 2),  # the largest calls
    (192, 32, 32, 33, 33, 1),    # few planes: one a block
    (2, 64, 64, 64, 64, 1),      # 32 KB a plane: alone
    (2, 80, 80, 80, 80, 0),      # 51 KB a plane: the tile kernel
    (2001, 8, 8, 9, 9, 4),       # a ragged last run (2001 = 4 * 500 + 1)
])
def test_plane_plan_branches(p, h, w, oh, ow, want):
  assert fir.plane_plan(p, h, w, oh, ow) == want
