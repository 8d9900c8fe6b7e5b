"""Tests of the port that need a CUDA card (marker `cuda`).

They skip without a card. The machine with the card has no JAX, so this
file imports only torch and the port, and runs without the repository's
conftest:

  python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from indm_torch.ops import group_norm as gn

pytestmark = pytest.mark.cuda

GEOMS = [
    # (n, h, w, c, num_groups): the CPU test's shapes, then full-width
    # NCSN++ shapes (the widest row: 384 channels at 32x32)
    (4, 8, 8, 32, 8),
    (6, 16, 16, 64, 16),
    (3, 32, 32, 16, 4),
    (2, 4, 4, 24, 6),
    (4, 32, 32, 384, 32),
    (4, 16, 16, 512, 32),
    (4, 4, 4, 512, 32),
]


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
  return torch.device("cuda")


@pytest.mark.parametrize("act", ["none", "swish"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", GEOMS)
def test_group_norm_kernel_matches_plain(cuda_device, geom, dtype, act):
  """The kernel against its plain version on the same inputs: 1e-5 for
  float32 (sums in another order), 2e-2 for bfloat16 (one rounding of the
  output can land one bf16 step apart)."""
  n, h, w, c, g = geom
  rng = np.random.default_rng(0)
  tdt = torch.float32 if dtype == "float32" else torch.bfloat16
  x = torch.from_numpy(rng.normal(0.5, 1.5, size=(n, c, h, w)).astype(
      np.float32)).to(cuda_device, tdt)
  scale = torch.from_numpy(rng.normal(1.0, 0.2, size=(c,)).astype(
      np.float32)).to(cuda_device)
  bias = torch.from_numpy(rng.normal(0.0, 0.2, size=(c,)).astype(
      np.float32)).to(cuda_device)
  before = gn.launches
  y = gn.group_norm_act(x, scale, bias, g, act=act)
  torch.cuda.synchronize()
  assert gn.launches == before + 1
  assert y.dtype == tdt and y.shape == x.shape
  y_plain = gn.group_norm_act_plain(x, scale, bias, g, act=act)
  tol = 1e-5 if dtype == "float32" else 2e-2
  torch.testing.assert_close(y.float(), y_plain.float(), atol=tol, rtol=tol)


def test_group_norm_kernel_rejects_noncontiguous(cuda_device):
  x = torch.randn(2, 8, 4, 4, device=cuda_device).transpose(2, 3)
  s = torch.ones(8, device=cuda_device)
  with pytest.raises(ValueError):
    gn.group_norm_act(x, s, s, 4)
