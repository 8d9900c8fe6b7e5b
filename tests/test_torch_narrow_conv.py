"""The port's narrow-channel conv (`indm_torch.ops.narrow_conv`) and its
benchmark (`indm_torch.scripts.bench_narrow_conv`), against the JAX
package's narrow-conv benchmark.

The JAX side is `pallas_conv` of the unchanged `scripts/bench_narrow_conv.py`
(loaded by path; interpret mode on the CPU, as the script runs it off a
TPU) and `lax.conv_general_dilated`, on the same numpy inputs. The port's
wrapper takes its plain version on these CPU tensors; the CUDA kernel is
held against the plain version on the card by `test_torch_cuda.py` and
`chip_smoke.py`.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from indm_torch.ops import narrow_conv as nc
from indm_torch.scripts import bench_narrow_conv as bench
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, HW, C, IDIM = 4, 8, 3, 64
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def jax_bench():
  spec = importlib.util.spec_from_file_location(
      "jax_bench_narrow_conv", os.path.join(REPO, "scripts",
                                            "bench_narrow_conv.py"))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def _inputs(kind, seed=0):
  """NHWC x and HWIO w (times 0.05, as the script's) from numpy."""
  rng = np.random.default_rng(seed)
  cin, cout = (C, IDIM) if kind == "narrow_in" else (IDIM, C)
  x = rng.standard_normal((B, HW, HW, cin)).astype(np.float32)
  w = (rng.standard_normal((3, 3, cin, cout)) * 0.05).astype(np.float32)
  return x, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["narrow_in", "narrow_out"])
def test_plain_matches_pallas_conv_and_lax(jax_bench, kind, dtype):
  """`narrow_conv_plain` against the JAX script's `pallas_conv` and
  `lax.conv_general_dilated` on the same inputs. float32: rtol 1e-5 (and
  atol 1e-6 for outputs near 0, float32 sums of 27 or 576 products in
  another order). bfloat16: both round a float32 sum once to bfloat16, so
  they may land one bfloat16 step apart: 1e-2 of the largest value."""
  jdt, tdt = DTYPES[dtype]
  x, w = _inputs(kind)
  xj, wj = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
  want_pl = np.asarray(jax_bench.pallas_conv(xj, wj, kind), np.float32)
  want_lax = np.asarray(lax.conv_general_dilated(
      xj, wj, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
      preferred_element_type=jnp.float32).astype(jdt), np.float32)
  xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).to(tdt)
  wt = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))).to(tdt)
  nc.reset_launches()
  got = nc.narrow_conv(xt, wt)
  assert nc.launches == 0  # a CPU tensor never reaches the kernel
  assert got.dtype == tdt
  assert tuple(got.shape) == (B, w.shape[-1], HW, HW)
  got = got.float().permute(0, 2, 3, 1).numpy()
  for want in (want_pl, want_lax):
    if dtype == "float32":
      np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
      assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


def test_check_refuses_what_the_kernel_does_not_take():
  """The checks the wrapper runs before a launch."""
  x = torch.zeros(2, 3, 8, 8)
  w = torch.zeros(64, 3, 3, 3)
  nc._check(x, w)
  nc._check(torch.zeros(2, 64, 8, 8), torch.zeros(12, 64, 3, 3))
  for bx, bw in ((x.double(), w.double()),                 # float64
                 (x, w.bfloat16()),                        # mixed types
                 (x.transpose(2, 3), w),                   # not contiguous
                 (torch.zeros(2, 4, 8, 8), torch.zeros(64, 4, 3, 3)),
                 (x, torch.zeros(30, 3, 3, 3)),            # wide side < 33
                 (x, torch.zeros(66, 3, 3, 3)),            # not a multiple of 4
                 (x, torch.zeros(64, 3, 1, 1)),            # not 3x3
                 (torch.zeros(65536, 3, 1, 1), w)):        # batch > grid z
    with pytest.raises(ValueError):
      nc._check(bx, bw)


def test_benchmark_runs_on_the_cpu(monkeypatch, capsys):
  """The benchmark's entry point at NC_BATCH=2, NC_HW=8 on the CPU: the
  six cases in the JAX script's order, each printed, finite, and within
  1e-2 of the largest value of its kind's first case (bfloat16)."""
  monkeypatch.setenv("NC_BATCH", "2")
  monkeypatch.setenv("NC_HW", "8")
  rows = bench.main(["--device", "cpu"])
  out = capsys.readouterr().out
  assert [(r["kind"], r["impl"]) for r in rows] == [
      (k, i) for k in ("narrow_in", "narrow_out")
      for i in ("plain", "direct", "cuda")]
  for r in rows:
    assert r["name"] in out
    assert np.isfinite(r["ms"]) and r["ms"] > 0
    assert r["max_dev"] <= 1e-2 * r["largest"]
    assert r["max_dev_direct"] <= 1e-2 * r["largest"]
  assert rows[0]["max_dev"] == 0.0


def test_benchmark_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
  """Without a card the default device raises: the script never times the
  CPU under the card's name."""
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  monkeypatch.setenv("NC_BATCH", "2")
  monkeypatch.setenv("NC_HW", "8")
  with pytest.raises(RuntimeError, match="cpu"):
    bench.main([])
