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


# (n, c, h, w, num_groups, act): the training shapes' kinds at small batch
GN_BWD_GEOMS = [
    (4, 32, 8, 8, 8, "swish"),
    (3, 16, 32, 32, 4, "none"),
    (2, 24, 4, 4, 6, "swish"),
    (4, 384, 32, 32, 32, "swish"),   # the row too long for shared memory
    (4, 512, 16, 16, 32, "swish"),
    (4, 256, 4, 4, 32, "none"),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", GN_BWD_GEOMS)
def test_group_norm_backward_kernel_matches_plain(cuda_device, geom, dtype):
  """dx, dscale and dbias of the kernel pair against the plain backward on
  the same inputs. float32: sums in another order, 1e-4 of the largest
  value. bfloat16: dx is rounded to bf16 once (2e-2); the parameter
  gradients are float32 sums of the same bf16 inputs (1e-3)."""
  n, c, h, w, g, act = geom
  rng = np.random.default_rng(1)
  tdt = torch.float32 if dtype == "float32" else torch.bfloat16

  def t(*shape, loc=0.0, scale=1.0):
    return torch.from_numpy(rng.normal(loc, scale, size=shape).astype(
        np.float32)).to(cuda_device)

  x, dy = t(n, c, h, w, loc=0.5, scale=1.5).to(tdt), t(n, c, h, w).to(tdt)
  scale, bias = t(c, loc=1.0, scale=0.2), t(c, scale=0.2)
  before = gn.bwd_launches
  dx, ds, db = gn.group_norm_act_backward(x, dy, scale, bias, g, act=act)
  torch.cuda.synchronize()
  assert gn.bwd_launches == before + 1
  assert dx.dtype == tdt and ds.dtype == db.dtype == torch.float32
  ref = gn.group_norm_act_backward_plain(x, dy, scale, bias, g, act=act)
  tols = ((1e-4, 1e-4, 1e-4) if dtype == "float32" else (2e-2, 1e-3, 1e-3))
  for got, want, tol in zip((dx, ds, db), ref, tols):
    big = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), atol=tol * big,
                               rtol=tol)
  # the batch sum runs in a fixed order: the same bits every time
  _, ds2, db2 = gn.group_norm_act_backward(x, dy, scale, bias, g, act=act)
  assert torch.equal(ds, ds2) and torch.equal(db, db2)


def test_group_norm_autograd_goes_through_both_kernels(cuda_device):
  x = torch.randn(2, 32, 8, 8, device=cuda_device, requires_grad=True)
  s = torch.ones(32, device=cuda_device, requires_grad=True)
  b = torch.zeros(32, device=cuda_device, requires_grad=True)
  f0, b0 = gn.launches, gn.bwd_launches
  y = gn.GroupNormAct.apply(x, s, b, 8, 1e-6, "swish")
  y.square().sum().backward()
  torch.cuda.synchronize()
  assert (gn.launches, gn.bwd_launches) == (f0 + 1, b0 + 1)
  assert torch.isfinite(x.grad).all() and torch.isfinite(s.grad).all()


# (b, c, h, w, idim): small shapes, then one sample of each full-width scale
CHAIN_GEOMS = [(2, 3, 8, 8, 64), (2, 12, 8, 8, 32), (3, 3, 16, 16, 132),
               (1, 3, 32, 32, 512), (1, 12, 16, 16, 512)]


def chain_inputs(b, c, h, w, idim, preact, device, seed=0):
  """vareps, diagonals cos(2 pi a) and transposed weights (application
  order) of variance 1 / fan_in, so that every term of the series stays of
  order one and shows in the sum."""
  rng = np.random.default_rng(seed)

  def t(*shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        device)

  ws = [t(*shape) / np.sqrt(np.prod(shape[1:]))
        for shape in ((idim, c, 3, 3), (idim, idim, 1, 1), (c, idim, 3, 3))]
  dacts = [torch.cos(2 * np.pi * t(b, idim, h, w)),
           torch.cos(2 * np.pi * t(b, idim, h, w))]
  if preact:
    dacts.append(torch.cos(2 * np.pi * t(b, c, h, w)))
  return t(b, c, h, w), dacts, ws


@pytest.mark.parametrize("n", [0, 2, 6])
@pytest.mark.parametrize("preact", [True, False])
@pytest.mark.parametrize("geom", CHAIN_GEOMS)
def test_neumann_chain_kernel_matches_plain(cuda_device, geom, preact, n):
  """The kernel against the plain version (cuDNN convs, TF32 off) on the
  same inputs: float32 sums in another order over up to 4608 products a
  term, 1e-4 of the largest value."""
  from indm_torch.flows.resflow import OFFSET_TRAIN, RCDF_TRAIN
  from indm_torch.ops import neumann
  torch.backends.cudnn.allow_tf32 = False
  vareps, dacts, ws = chain_inputs(*geom, preact, cuda_device)
  before = neumann.launches
  acc = neumann.neumann_chain(vareps, dacts, ws, n, OFFSET_TRAIN, RCDF_TRAIN)
  torch.cuda.synchronize()
  assert neumann.launches == before + 1
  ref = neumann.neumann_chain_plain(vareps, dacts, ws, n, OFFSET_TRAIN,
                                    RCDF_TRAIN)
  big = ref.abs().max().item()
  torch.testing.assert_close(acc, ref, atol=1e-4 * big, rtol=1e-4)


def test_neumann_chain_rejects_unsupported(cuda_device):
  from indm_torch.ops import neumann
  vareps, dacts, ws = chain_inputs(1, 3, 8, 8, 16, True, cuda_device)
  with pytest.raises(ValueError):
    neumann.neumann_chain(vareps.double(), dacts, ws, 1, 2, [1.0] * 129)
  v4, d4, w4 = chain_inputs(1, 4, 8, 8, 16, True, cuda_device)
  with pytest.raises(ValueError):
    neumann.neumann_chain(v4, d4, w4, 1, 2, [1.0] * 129)
