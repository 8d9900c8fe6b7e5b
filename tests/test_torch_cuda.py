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
from torch_threads import one_torch_thread  # noqa: F401

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
    # the 64x64 nets' (CelebA) longest rows
    (2, 64, 64, 384, 32),
    (2, 64, 64, 256, 32),
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


# (n, c, h, w, num_groups, act, dtype, plan): one case for each branch of
# the backward's row plan (`group_norm.bwd_plan`: threads a row (log2),
# chunks a thread; (0, 0) the one-block-a-row kernel)
GN_BWD_PLAN_GEOMS = [
    (4, 256, 4, 4, 32, "swish", "float32", (5, 1)),   # a warp a row, 1 chunk
    (4, 512, 4, 4, 32, "swish", "float32", (5, 2)),
    (4, 256, 8, 8, 32, "none", "float32", (5, 4)),
    (3, 24, 4, 4, 3, "swish", "float32", (5, 1)),     # 9 rows: ragged block
    (5, 24, 8, 8, 3, "none", "float32", (5, 4)),      # 15 rows: ragged
    (4, 512, 8, 8, 32, "swish", "float32", (6, 4)),   # 2 warps a row
    (4, 256, 16, 16, 32, "none", "float32", (7, 4)),
    (3, 384, 16, 16, 32, "swish", "float32", (8, 4)),  # 3 chunks of 4
    (2, 256, 32, 32, 32, "swish", "float32", (9, 4)),  # 512 threads a row
    (2, 384, 32, 32, 32, "swish", "float32", (10, 4)),  # 48 KB, 1024 threads
    (2, 384, 32, 32, 32, "none", "bfloat16", (9, 4)),
    (4, 256, 4, 4, 32, "swish", "bfloat16", (5, 1)),
    (3, 48, 7, 7, 6, "swish", "float32", (7, 4)),      # 7x7: one value a chunk
    (2, 32, 32, 32, 1, "swish", "float32", (0, 0)),    # 32768 values a row
    # the 64x64 nets' (CelebA) rows: 16384 values in registers, and the
    # two rows past the plan, which take the one-block-a-row kernel
    (2, 128, 64, 64, 32, "swish", "float32", (10, 4)),
    (2, 256, 64, 64, 32, "swish", "float32", (0, 0)),
    (2, 384, 64, 64, 32, "swish", "float32", (0, 0)),
    (2, 384, 64, 64, 32, "none", "bfloat16", (0, 0)),
]


@pytest.mark.parametrize("geom", GN_BWD_PLAN_GEOMS)
def test_group_norm_backward_plan_branches_match_plain(cuda_device, geom):
  """Each branch of the backward kernel's launch plan against the plain
  backward, at phase 7's tolerances (float32 1e-4 of the largest value;
  bfloat16 dx 2e-2, the parameter gradients 1e-3), the same bits twice."""
  n, c, h, w, g, act, dtype, plan = geom
  rng = np.random.default_rng(2)
  tdt = getattr(torch, dtype)
  x = torch.from_numpy(rng.normal(0.5, 1.5, size=(n, c, h, w)).astype(
      np.float32)).to(cuda_device, tdt)
  dy = torch.from_numpy(rng.normal(size=(n, c, h, w)).astype(
      np.float32)).to(cuda_device, tdt)
  scale = torch.from_numpy(rng.normal(1.0, 0.2, size=(c,)).astype(
      np.float32)).to(cuda_device)
  bias = torch.from_numpy(rng.normal(0.0, 0.2, size=(c,)).astype(
      np.float32)).to(cuda_device)
  vec = (h * w) % (16 // x.element_size()) == 0
  assert gn.bwd_plan(c, h * w, g, x.element_size(), vec) == plan
  before = gn.bwd_launches
  got = gn.group_norm_act_backward(x, dy, scale, bias, g, act=act)
  again = gn.group_norm_act_backward(x, dy, scale, bias, g, act=act)
  torch.cuda.synchronize()
  assert gn.bwd_launches == before + 2
  ref = gn.group_norm_act_backward_plain(x, dy, scale, bias, g, act=act)
  tols = (1e-4, 1e-4, 1e-4) if dtype == "float32" else (2e-2, 1e-3, 1e-3)
  for a, b, want, tol in zip(got, again, ref, tols):
    assert torch.equal(a, b)
    big = want.float().abs().max().item()
    torch.testing.assert_close(a.float(), want.float(), atol=tol * big,
                               rtol=tol)


def test_group_norm_layer_without_gradients_launches_the_forward(
    cuda_device):
  """Under no_grad the fused layer launches the forward kernel once
  without `GroupNormAct`, with its output bit for bit."""
  from indm_torch.models import layers
  mod = layers.GroupNorm(8, 32, act="swish", fused=True, device=cuda_device)
  x = torch.randn(2, 32, 8, 8, device=cuda_device)
  want = gn.GroupNormAct.apply(x, mod.weight, mod.bias, 8, 1e-6, "swish")
  before = gn.launches
  with torch.no_grad():
    got = mod(x)
  torch.cuda.synchronize()
  assert gn.launches == before + 1 and torch.equal(got, want.detach())


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


# (b, c, h, w, idim): small shapes, then one sample of each full-width
# scale, CIFAR-10's (3 on 32x32, 12 on 16x16) and CelebA's (12 on 32x32,
# 48 on 16x16, after the flow's squeeze)
CHAIN_GEOMS = [(2, 3, 8, 8, 64), (2, 12, 8, 8, 32), (3, 3, 16, 16, 132),
               (1, 3, 32, 32, 512), (1, 12, 16, 16, 512),
               (2, 48, 8, 8, 64), (3, 48, 8, 12, 68),
               (1, 12, 32, 32, 512), (1, 48, 16, 16, 512)]


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
  term, 1e-4 of the largest value; each term's product one launch of the
  `wgmma` GEMM and no other GEMM (the library's host counts)."""
  from indm_torch.flows.resflow import OFFSET_TRAIN, RCDF_TRAIN
  from indm_torch.ops import lipnet_gemm as lg
  from indm_torch.ops import neumann
  torch.backends.cudnn.allow_tf32 = False
  vareps, dacts, ws = chain_inputs(*geom, preact, cuda_device)
  before = neumann.launches
  neumann.neumann_chain(vareps, dacts, ws, n, OFFSET_TRAIN, RCDF_TRAIN)
  g0 = lg.device_gemm_launches()
  acc = neumann.neumann_chain(vareps, dacts, ws, n, OFFSET_TRAIN, RCDF_TRAIN)
  g1 = lg.device_gemm_launches()
  torch.cuda.synchronize()
  assert neumann.launches == before + 2
  assert {k: g1[k] - g0[k] for k in g1} == {
      "gemm_3xtf32": 0, "wgmma": n + OFFSET_TRAIN, "gemm_bf16": 0}
  ref = neumann.neumann_chain_plain(vareps, dacts, ws, n, OFFSET_TRAIN,
                                    RCDF_TRAIN)
  big = ref.abs().max().item()
  torch.testing.assert_close(acc, ref, atol=1e-4 * big, rtol=1e-4)


@pytest.mark.parametrize("geom", [(4, 12, 32, 32, 512), (4, 48, 16, 16, 512),
                                  (2, 48, 16, 16, 132)])
def test_neumann_chain_at_celeba_scales_matches_float64(cuda_device, geom):
  """Kernel 7 at CelebA's two flow scales (12 channels on 32x32, 48 on
  16x16: conv_in's K in six groups, conv_out's outputs in four blocks)
  against the plain version on float64 inputs, n = 2 and 6 (pre-activated
  and not): within 1e-4 of the largest value, the same bits twice and for
  a sample alone."""
  from indm_torch.flows.resflow import OFFSET_TRAIN, RCDF_TRAIN
  from indm_torch.ops import neumann
  for preact in (True, False):
    vareps, dacts, ws = chain_inputs(*geom, preact, cuda_device, seed=3)
    for n in (2, 6):
      args = (n, OFFSET_TRAIN, RCDF_TRAIN)
      acc = neumann.neumann_chain(vareps, dacts, ws, *args)
      ref = neumann.neumann_chain_plain(
          vareps.double(), [d.double() for d in dacts],
          [w.double() for w in ws], *args, compute_dtype=torch.float32)
      assert_close_to_scale([acc.double()], [ref], 1e-4)
      assert torch.equal(acc, neumann.neumann_chain(vareps, dacts, ws,
                                                    *args))
      one = neumann.neumann_chain(
          vareps[:1].contiguous(), [d[:1].contiguous() for d in dacts], ws,
          *args)
      assert torch.equal(acc[:1], one)


def test_neumann_chain_rejects_unsupported(cuda_device):
  from indm_torch.ops import neumann
  vareps, dacts, ws = chain_inputs(1, 3, 8, 8, 16, True, cuda_device)
  with pytest.raises(ValueError):
    neumann.neumann_chain(vareps.double(), dacts, ws, 1, 2, [1.0] * 129)
  v4, d4, w4 = chain_inputs(1, 4, 8, 8, 16, True, cuda_device)
  with pytest.raises(ValueError):
    neumann.neumann_chain(v4, d4, w4, 1, 2, [1.0] * 129)
  # 48 channels: kernel 7 takes them in both types; kernel 8 refuses
  # them, naming the routing that sends such a block to kernel 7
  v48, d48, w48 = chain_inputs(1, 48, 8, 8, 16, True, cuda_device)
  before = neumann.bf16_launches
  neumann.neumann_chain(v48.bfloat16(), [d.bfloat16() for d in d48],
                        [w.bfloat16() for w in w48], 1, 2, [1.0] * 129)
  assert neumann.bf16_launches == before + 1
  d = fused_inputs(1, 48, 8, 8, 64, cond=True, device=cuda_device)
  with pytest.raises(ValueError, match="48 channels.*fused_chain_ok"):
    neumann.fused_neumann_chain(*fused_chain_args(d, True), 1, 2,
                                [1.0] * 129, True)


# (b, c, h, w, idim): small shapes, then one sample of each full-width scale
# of CIFAR-10 and of CelebA's first (12 channels on 32x32: the backward's
# padded planes past 48 KB of shared memory)
FUSED_GEOMS = [(2, 3, 8, 8, 64), (2, 12, 8, 8, 36), (3, 3, 16, 16, 132),
               (1, 3, 32, 32, 512), (1, 12, 16, 16, 512),
               (1, 12, 32, 32, 512)]


def fused_inputs(b, c, h, w, idim, cond, device, seed=0):
  """The fused pair's inputs: x, the normalised-weight stand-ins of
  variance 1 / fan_in (every chain term of order one), biases, hp, vareps,
  and the cotangents ybar, lbar."""
  rng = np.random.default_rng(seed)

  def t(*shape, scale=1.0):
    return torch.from_numpy((scale * rng.normal(size=shape)).astype(
        np.float32)).to(device)

  ws = [t(*shape) / np.sqrt(np.prod(shape[1:]))
        for shape in ((idim, c, 3, 3), (idim, idim, 1, 1), (c, idim, 3, 3))]
  bs = [t(idim, scale=0.1), t(idim, scale=0.1), t(c, scale=0.1)]
  hp = t(b, idim, scale=0.3) if cond else None
  return dict(x=t(b, c, h, w), ws=ws, bs=bs, hp=hp, eps=t(b, c, h, w),
              ybar=t(b, c, h, w), lbar=t(b))


def assert_close_to_scale(got, want, tol=1e-4):
  for g, r in zip(got, want):
    if r is None:
      assert g is None
      continue
    big = r.abs().max().item()
    assert (g - r).abs().max().item() <= tol * big, (g - r).abs().max()


@pytest.mark.parametrize("n", [0, 2, 6])
@pytest.mark.parametrize("preact", [True, False])
@pytest.mark.parametrize("geom", FUSED_GEOMS)
def test_fused_block_kernels_match_plain(cuda_device, geom, preact, n):
  """Kernels 3 and 4 against their plain versions (cuDNN convs, TF32 off)
  on the same inputs: each output within 1e-4 of its largest value (float32
  sums in another order, over up to 131 072 rows for the weight
  gradients); kernel 4 twice gives the same bits."""
  from indm_torch.flows.resflow import OFFSET_TRAIN, RCDF_TRAIN
  from indm_torch.ops import fused_block as fb
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  d = fused_inputs(*geom, cond=preact, device=cuda_device)
  args = (d["x"], *d["ws"], *d["bs"], d["hp"], d["eps"], n, OFFSET_TRAIN,
          RCDF_TRAIN, preact)
  f0, b0 = fb.fwd_launches, fb.bwd_launches
  out = fb.fused_block_fwd(*args)
  torch.cuda.synchronize()
  assert fb.fwd_launches == f0 + 1
  assert_close_to_scale(out, fb.fused_block_fwd_plain(*args))
  bargs = (d["x"], d["eps"], out[2], d["ybar"], d["lbar"], *d["ws"],
           *d["bs"][:2], d["hp"], preact)
  grads = fb.fused_block_bwd(*bargs)
  torch.cuda.synchronize()
  assert fb.bwd_launches == b0 + 1
  assert_close_to_scale(grads, fb.fused_block_bwd_plain(*bargs))
  again = fb.fused_block_bwd(*bargs)
  assert all(g is None and a is None or torch.equal(g, a)
             for g, a in zip(grads, again))


def test_fused_block_kernels_reject_unsupported(cuda_device):
  from indm_torch.ops import fused_block as fb
  d = fused_inputs(2, 3, 8, 8, 64, True, cuda_device)

  def fwd(x=d["x"], ws=d["ws"], eps=d["eps"]):
    return fb.fused_block_fwd(x, *ws, *d["bs"], d["hp"], eps, 1, 2,
                              [1.0] * 129, True)

  with pytest.raises(ValueError):
    fwd(x=d["x"].double())
  with pytest.raises(ValueError):
    fwd(eps=d["eps"].transpose(2, 3))
  narrow = fused_inputs(2, 3, 8, 8, 32, True, cuda_device)  # width < 33
  with pytest.raises(ValueError):
    fwd(ws=narrow["ws"])
  c4 = fused_inputs(2, 4, 8, 8, 64, True, cuda_device)
  with pytest.raises(ValueError):
    fb.fused_block_fwd(c4["x"], *c4["ws"], *c4["bs"], c4["hp"], c4["eps"], 1,
                       2, [1.0] * 129, True)
  with pytest.raises(ValueError):
    fb.fused_block_bwd(d["x"], d["eps"], d["eps"], d["ybar"].double(),
                       d["lbar"], *d["ws"], *d["bs"][:2], d["hp"], True)


def test_fused_block_fn_backward_goes_through_kernel_4(cuda_device):
  from indm_torch.ops import fused_block as fb
  d = fused_inputs(2, 3, 8, 8, 64, True, cuda_device)
  x = d["x"].requires_grad_()
  ws = [w.requires_grad_() for w in d["ws"]]
  f0, b0 = fb.fwd_launches, fb.bwd_launches
  y, ld = fb.FusedBlockFn.apply(x, *ws, *d["bs"], d["hp"], d["eps"], 2, 2,
                                [1.0] * 129, True)
  ((y * y).sum() + ld.sum()).backward()
  torch.cuda.synchronize()
  assert (fb.fwd_launches, fb.bwd_launches) == (f0 + 1, b0 + 1)
  assert torch.isfinite(x.grad).all() and all(
      torch.isfinite(w.grad).all() for w in ws)


# (b, c, h, w, idim, blocks): small stacks, then one sample of each
# full-width scale
STACK_GEOMS = [(2, 3, 8, 8, 64, 3), (2, 12, 8, 8, 36, 2),
               (1, 3, 32, 32, 512, 3), (1, 12, 16, 16, 512, 2),
               (1, 12, 32, 32, 512, 2)]


def stack_inputs(b, c, h, w, idim, nb, cond, device, seed=0):
  """A stack of `nb` blocks' fused-pair inputs (`fused_inputs`), stacked on
  a leading block axis, with x, ybar and lbar of the first block and n_all
  in 0..3."""
  blocks = [fused_inputs(b, c, h, w, idim, cond, device, seed + j)
            for j in range(nb)]

  def stacked(get):
    return None if get(blocks[0]) is None else torch.stack(
        [get(d) for d in blocks])

  return dict(x=blocks[0]["x"], ybar=blocks[0]["ybar"],
              lbar=blocks[0]["lbar"],
              ws=[stacked(lambda d, k=k: d["ws"][k]) for k in range(3)],
              bs=[stacked(lambda d, k=k: d["bs"][k]) for k in range(3)],
              hp=stacked(lambda d: d["hp"]), eps=stacked(lambda d: d["eps"]),
              n_all=[int(n) for n in
                     np.random.default_rng(seed).integers(0, 4, nb)])


def _slice(t, j):
  """Block j's slice as a tensor of its own (16-byte aligned, as the block
  kernels ask of every input)."""
  return None if t is None else t[j].clone()


@pytest.mark.parametrize("cond", [True, False])
@pytest.mark.parametrize("geom", STACK_GEOMS)
def test_fused_stack_kernels_match_plain_and_looped_pair(cuda_device, geom,
                                                          cond):
  """Kernels 5 and 6 against their plain versions on the same inputs (each
  output within 1e-4 of its largest value, as kernels 3 and 4), against
  kernels 3 and 4 looped over the same blocks (the same bits: the stack
  runs the same device code on each block), and twice (the same bits)."""
  from indm_torch.flows.resflow import OFFSET_TRAIN, RCDF_TRAIN
  from indm_torch.ops import fused_block as fb
  from indm_torch.ops import fused_stack as fs
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  d = stack_inputs(*geom, cond=cond, device=cuda_device)
  args = (d["x"], *d["ws"], *d["bs"], d["hp"], d["eps"], d["n_all"],
          OFFSET_TRAIN, RCDF_TRAIN, True)
  f0, b0 = fs.fwd_launches, fs.bwd_launches
  out = fs.fused_stack_fwd(*args)
  torch.cuda.synchronize()
  assert fs.fwd_launches == f0 + 1
  assert_close_to_scale(out, fs.fused_stack_fwd_plain(*args))
  y, ld_all, u_all, xs_all = out
  bargs = (xs_all, d["eps"], u_all, d["ybar"], d["lbar"], *d["ws"],
           *d["bs"][:2], d["hp"], True)
  grads = fs.fused_stack_bwd(*bargs)
  torch.cuda.synchronize()
  assert fs.bwd_launches == b0 + 1
  assert_close_to_scale(grads, fs.fused_stack_bwd_plain(*bargs))
  again = fs.fused_stack_bwd(*bargs)
  assert all(g is None and a is None or torch.equal(g, a)
             for g, a in zip(grads, again))

  x = d["x"]
  for j, n in enumerate(d["n_all"]):
    assert torch.equal(xs_all[j], x)
    x, ld, u = fb.fused_block_fwd(
        x, *(_slice(t, j) for t in d["ws"] + d["bs"]), _slice(d["hp"], j),
        _slice(d["eps"], j), n, OFFSET_TRAIN, RCDF_TRAIN, True)
    assert torch.equal(ld_all[j], ld) and torch.equal(u_all[j], u)
  assert torch.equal(y, x)
  cot = d["ybar"]
  for j in reversed(range(len(d["n_all"]))):
    cot, *per_block = fb.fused_block_bwd(
        _slice(xs_all, j), _slice(d["eps"], j), _slice(u_all, j), cot,
        d["lbar"], *(_slice(t, j) for t in d["ws"] + d["bs"][:2]),
        _slice(d["hp"], j), True)
    assert all(g is None and s is None or torch.equal(s[j], g)
               for s, g in zip(grads[1:], per_block))
  assert torch.equal(grads[0], cot)


def test_fused_stack_kernels_reject_unsupported(cuda_device):
  from indm_torch.ops import fused_stack as fs
  d = stack_inputs(2, 3, 8, 8, 64, 3, True, cuda_device)

  def fwd(x=d["x"], ws=d["ws"], eps=d["eps"], n_all=d["n_all"]):
    return fs.fused_stack_fwd(x, *ws, *d["bs"], d["hp"], eps, n_all, 2,
                              [1.0] * 129, True)

  with pytest.raises(ValueError):
    fwd(x=d["x"].double())
  with pytest.raises(ValueError):
    fwd(eps=d["eps"][:2])                        # two blocks of noise
  with pytest.raises(ValueError):
    fwd(eps=d["eps"].transpose(3, 4))
  with pytest.raises(ValueError):
    fwd(ws=[d["ws"][0].cpu()] + d["ws"][1:])     # a weight on the CPU
  with pytest.raises(ValueError):
    fwd(n_all=[1, -1, 2])
  y, _, u_all, xs_all = fwd()
  with pytest.raises(ValueError):
    fs.fused_stack_bwd(xs_all, d["eps"], u_all, d["ybar"].double(),
                       d["lbar"], *d["ws"], *d["bs"][:2], d["hp"], True)
  with pytest.raises(ValueError):
    fs.fused_stack_bwd(xs_all, d["eps"], u_all[:2], d["ybar"], d["lbar"],
                       *d["ws"], *d["bs"][:2], d["hp"], True)


def test_fused_stack_fn_backward_goes_through_kernel_6(cuda_device):
  from indm_torch.ops import fused_stack as fs
  d = stack_inputs(2, 3, 8, 8, 64, 3, True, cuda_device)
  x = d["x"].requires_grad_()
  ws = [w.requires_grad_() for w in d["ws"]]
  f0, b0 = fs.fwd_launches, fs.bwd_launches
  y, ld = fs.FusedStackFn.apply(x, *ws, *d["bs"], d["hp"], d["eps"],
                                d["n_all"], 2, [1.0] * 129, True)
  ((y * y).sum() + ld.sum()).backward()
  torch.cuda.synchronize()
  assert (fs.fwd_launches, fs.bwd_launches) == (f0 + 1, b0 + 1)
  assert torch.isfinite(x.grad).all() and all(
      torch.isfinite(w.grad).all() for w in ws)


def test_flow_stack_route_matches_block_route_on_card(cuda_device,
                                                      monkeypatch):
  """A `ResidualFlow((3, 2))` at width 64 on the card: the stack route
  (switch unset) against INDM_FUSED_STACK=0. z and every block's
  computation are the same bits; logpx sums the stack's log-dets before
  subtracting them, and autograd adds h's gradient over the blocks in
  another order, so the rest within 1e-5 of each tensor's largest value."""
  from indm_torch.flows.resflow import ResidualFlow
  from indm_torch.ops import fused_block as fb
  from indm_torch.ops import fused_stack as fs
  flow = ResidualFlow(8, 3, n_blocks=(3, 2), intermediate_dim=64,
                      cond_dim=16, fused_block=True,
                      generator=torch.Generator().manual_seed(0)).to(
                          cuda_device)
  gen = torch.Generator(device=cuda_device).manual_seed(1)
  x = torch.randn(4, 3, 8, 8, device=cuda_device, generator=gen)
  h = torch.randn(4, 16, device=cuda_device, generator=gen)
  noise = flow.sample_noise(x.shape, gen, np.random.default_rng(2),
                            cuda_device)

  def run(switch):
    monkeypatch.setenv("INDM_FUSED_STACK", switch)
    flow.zero_grad()
    xx, hh = x.clone().requires_grad_(), h.clone().requires_grad_()
    counts = (fs.fwd_launches, fs.bwd_launches, fb.fwd_launches,
              fb.bwd_launches)
    z, logpx = flow.fwdpass(xx, hh, noise)
    (0.1 * (z * torch.cos(z)).sum() + 0.7 * logpx.sum()).backward()
    torch.cuda.synchronize()
    counts = tuple(a - b for a, b in zip(
        (fs.fwd_launches, fs.bwd_launches, fb.fwd_launches, fb.bwd_launches),
        counts))
    return counts, z.detach(), [logpx.detach(), xx.grad, hh.grad] + [
        p.grad.clone() for p in flow.parameters()]

  c_stack, z_stack, rest_stack = run("1")
  c_pair, z_pair, rest_pair = run("0")
  assert c_stack == (2, 2, 1, 1) and c_pair == (0, 0, 5, 5)
  assert torch.equal(z_stack, z_pair)
  assert_close_to_scale(rest_stack, rest_pair, tol=1e-5)


# (batch*channels split as (n, c), h, w, kernel, up, down, pad): the path's
# three kinds at reduced batch, the widest up=2 input, and a general case
# (an asymmetric 5x3 kernel, up and down both 2, odd sizes)
FIR_GEOMS = [
    ((4, 128), 32, 32, "fir", 1, 2, (1, 1)),   # downsample_2d
    ((4, 3), 32, 32, "fir", 1, 1, (2, 2)),     # conv_downsample_2d's FIR
    ((4, 256), 16, 16, "fir4", 2, 1, (2, 1)),  # upsample_2d
    ((3, 5), 7, 9, "odd", 2, 2, (3, 0)),
]


def _fir_taps(kind):
  from indm_torch.ops import upfirdn2d as fir
  if kind == "odd":
    return np.random.default_rng(3).normal(size=(5, 3)).astype(np.float32)
  k = fir.setup_kernel([1, 3, 3, 1])
  return k * 4 if kind == "fir4" else k


@pytest.mark.parametrize("geom", FIR_GEOMS)
def test_upfirdn2d_kernel_matches_plain(cuda_device, geom):
  """Kernel 9 against its plain version on the same inputs, within 1e-5 of
  the output's largest value (float32 sums in another order); one launch
  per call."""
  from indm_torch.ops import upfirdn2d as fir
  (n, c), h, w, kind, up, down, pad = geom
  k = _fir_taps(kind)
  x = torch.from_numpy(np.random.default_rng(0).normal(
      size=(n, c, h, w)).astype(np.float32)).to(cuda_device)
  before = fir.launches
  y = fir.upfirdn2d(x, k, up, down, pad)
  torch.cuda.synchronize()
  assert fir.launches == before + 1
  want = fir.upfirdn2d_plain(x, k, up, down, pad)
  assert y.shape == want.shape
  scale = want.abs().max().item()
  assert (y - want).abs().max().item() <= 1e-5 * scale


# the VE net's nine calls at batch 2: (C, H, W, up, down, pad); taps 4x4,
# gain 4 for up = 2 (the plan table of `upfirdn2d.cu`'s note)
FIR_NET_CALLS = [
    (3, 32, 32, 1, 1, (2, 2)), (128, 16, 16, 1, 1, (2, 2)),
    (128, 32, 32, 1, 2, (1, 1)), (256, 4, 4, 2, 1, (2, 1)),
    (256, 8, 8, 1, 1, (2, 2)), (256, 8, 8, 1, 2, (1, 1)),
    (256, 8, 8, 2, 1, (2, 1)), (256, 16, 16, 1, 2, (1, 1)),
    (256, 16, 16, 2, 1, (2, 1)),
    # the 64x64 VE net's (CelebA) calls that the 32x32 net does not make
    (3, 64, 64, 1, 1, (2, 2)), (128, 32, 32, 1, 1, (2, 2)),
    (128, 64, 64, 1, 2, (1, 1)), (256, 32, 32, 1, 2, (1, 1)),
    (256, 32, 32, 2, 1, (2, 1)),
]
# other branches: (n, c, h, w, taps, up, down, pad, planes a block)
FIR_PLAN_GEOMS = [
    (3, 5, 7, 9, "odd", 2, 2, (3, 0), 0),     # not separable: tiles
    (2, 3, 8, 8, "sep8", 1, 1, (4, 3), 1),    # 8x8 separable: 8 taps
    (2, 3, 8, 8, "sep8", 2, 1, (4, 3), 1),    # its phases: 4 taps each
    (2, 3, 8, 8, "rand8", 1, 2, (3, 4), 0),   # 8x8 not separable
    (3, 667, 8, 8, "fir", 1, 1, (2, 2), 4),   # 2001 planes: a ragged run
    (2, 6, 7, 9, "fir4", 2, 2, (2, 1), 1),    # 63 values a plane: no vectors
    (2, 4, 80, 80, "fir", 1, 1, (2, 2), 0),   # 51 KB a plane: tiles
]


def _fir_kernel(kind):
  from indm_torch.ops import upfirdn2d as fir
  rng = np.random.default_rng(4)
  if kind == "sep8":
    return np.outer(rng.uniform(0.5, 1.5, 8),
                    rng.uniform(0.5, 1.5, 8)).astype(np.float32)
  if kind == "rand8":
    return rng.normal(size=(8, 8)).astype(np.float32)
  return _fir_taps(kind) if kind != "fir" else fir.setup_kernel([1, 3, 3, 1])


def _check_fir(fir, x, k, up, down, pad):
  before = fir.launches
  y = fir.upfirdn2d(x, k, up, down, pad)
  torch.cuda.synchronize()
  assert fir.launches == before + 1
  want = fir.upfirdn2d_plain(x, k, up, down, pad)
  assert y.shape == want.shape
  assert (y - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("call", FIR_NET_CALLS)
def test_upfirdn2d_kernel_matches_plain_at_the_net_calls(cuda_device, call):
  """Kernel 9 (the whole-plane kernel, on the factored taps) at each of
  the VE net's calls at batch 2, within 1e-5 of the output's largest
  value (FIR_RTOL)."""
  from indm_torch.ops import upfirdn2d as fir
  c, h, w, up, down, pad = call
  k = fir.setup_kernel([1, 3, 3, 1]) * (4.0 if up == 2 else 1.0)
  x = torch.from_numpy(np.random.default_rng(5).normal(
      size=(2, c, h, w)).astype(np.float32)).to(cuda_device)
  oh = fir.out_size(h, 4, up, down, pad)
  assert fir.plane_plan(2 * c, h, w, oh, oh) > 0
  _check_fir(fir, x, k, up, down, pad)


@pytest.mark.parametrize("call", FIR_NET_CALLS)
def test_upfirdn2d_backward_matches_plain_at_the_net_calls(cuda_device, call):
  """Kernel 9's backward (`Upfirdn2dFn`: the kernel on the adjoint) at each
  of the VE net's calls at batch 2: the output keeps its backward, one
  launch each way, and the input gradient within 1e-5 of its largest
  value from autograd of the plain version on float64 inputs."""
  from indm_torch.ops import upfirdn2d as fir
  c, h, w, up, down, pad = call
  k = fir.setup_kernel([1, 3, 3, 1]) * (4.0 if up == 2 else 1.0)
  rng = np.random.default_rng(7)
  x = torch.from_numpy(rng.normal(size=(2, c, h, w)).astype(
      np.float32)).to(cuda_device).requires_grad_(True)
  before = (fir.launches, fir.bwd_launches)
  y = fir.upfirdn2d(x, k, up, down, pad)
  assert type(y.grad_fn).__name__ == "Upfirdn2dFnBackward"
  dy = torch.from_numpy(rng.normal(size=tuple(y.shape)).astype(
      np.float32)).to(cuda_device)
  (dx,) = torch.autograd.grad(y, x, dy)
  torch.cuda.synchronize()
  assert (fir.launches, fir.bwd_launches) == (before[0] + 1, before[1] + 1)
  x64 = x.detach().double().requires_grad_(True)
  (want,) = torch.autograd.grad(fir.upfirdn2d_plain(x64, k, up, down, pad),
                                x64, dy.double())
  assert dx.shape == x.shape
  assert (dx.double() - want).abs().max().item() <= \
      1e-5 * want.abs().max().item()


def test_upfirdn2d_needing_a_gradient_never_drops_the_graph(cuda_device):
  """A CUDA input that needs a gradient whose adjoint the kernel cannot
  take (a pad past the taps) raises and launches nothing; without a
  gradient the same call runs bare."""
  from indm_torch.ops import upfirdn2d as fir
  k = fir.setup_kernel([1, 3, 3, 1])
  x = torch.randn(2, 3, 8, 8, device=cuda_device, requires_grad=True)
  before = (fir.launches, fir.bwd_launches)
  with pytest.raises(ValueError, match="adjoint"):
    fir.upfirdn2d(x, k, 1, 1, (5, 0))
  assert (fir.launches, fir.bwd_launches) == before
  with torch.no_grad():
    y = fir.upfirdn2d(x, k, 1, 1, (5, 0))
  assert y.grad_fn is None and fir.launches == before[0] + 1


@pytest.mark.parametrize("geom", FIR_PLAN_GEOMS)
def test_upfirdn2d_plan_branches_match_plain(cuda_device, geom):
  """The kernel's other branches against its plain version at 1e-5 of the
  largest value: a kernel that is not separable (5x3 with up = down = 2,
  a random 8x8) and planes too large for the whole-plane kernel take the
  tile kernel; a separable 8x8; a run of planes cut short at the end;
  planes whose size leaves no 16-byte loads or stores."""
  from indm_torch.ops import upfirdn2d as fir
  n, c, h, w, kind, up, down, pad, ppb = geom
  k = _fir_kernel(kind)
  t = fir.taps(k)
  oh = fir.out_size(h, k.shape[0], up, down, pad)
  ow = fir.out_size(w, k.shape[1], up, down, pad)
  assert (fir.plane_plan(n * c, h, w, oh, ow) if t.col is not None
          else 0) == ppb
  x = torch.from_numpy(np.random.default_rng(6).normal(
      size=(n, c, h, w)).astype(np.float32)).to(cuda_device)
  _check_fir(fir, x, k, up, down, pad)


def test_upfirdn2d_kernel_rejects_unsupported(cuda_device):
  """No fallback on the card: another dtype, up or down outside (1, 2),
  a negative pad or a kernel over 8x8 raise, and launch nothing."""
  from indm_torch.ops import upfirdn2d as fir
  k = fir.setup_kernel([1, 3, 3, 1])
  x = torch.randn(2, 3, 8, 8, device=cuda_device)
  before = fir.launches
  with pytest.raises(TypeError):
    fir.upfirdn2d(x.double(), k, 1, 2, (1, 1))
  for up, down, pad, kk in ((3, 1, (1, 1), k), (1, 4, (1, 1), k),
                            (1, 1, (-1, 1), k),
                            (1, 1, (4, 4), np.ones((9, 9), np.float32))):
    with pytest.raises(ValueError):
      fir.upfirdn2d(x, kk, up, down, pad)
  assert fir.launches == before


def test_ve_score_net_goes_through_the_fir_kernel(cuda_device):
  """One VE score evaluation at a small geometry launches kernel 9 once per
  FIR resampling (two per BigGAN up or down block, one per pyramid level)
  and agrees with the same net through the plain version."""
  from indm_torch import sde as sde_lib
  from indm_torch.configs import get_config
  from indm_torch.models.registry import create_model, get_score_fn
  from indm_torch.ops import upfirdn2d as fir
  from indm_torch.run_lib import set_f32_numerics
  set_f32_numerics()
  cfg = get_config("ve/CIFAR10/indm")
  cfg.data.image_size = 16
  cfg.model.update(nf=16, num_res_blocks=1, ch_mult=(1, 2, 2),
                   attn_resolutions=(8,), init_scale=1.0)
  model = create_model(cfg, seed=0, device=cuda_device)
  score_fn = get_score_fn(cfg, sde_lib.get_sde(cfg), model)
  gen = torch.Generator(device=cuda_device).manual_seed(1)
  x = torch.randn(2, 3, 16, 16, device=cuda_device, generator=gen)
  t = torch.full((2,), 0.4, device=cuda_device)
  before = fir.launches
  s = score_fn(x, t)
  torch.cuda.synchronize()
  # 2 down blocks x 2 + 2 pyramid levels + 2 up blocks x 2
  assert fir.launches - before == 10
  kernel = fir.upfirdn2d
  fir.upfirdn2d = fir.upfirdn2d_plain
  try:
    want = score_fn(x, t)
  finally:
    fir.upfirdn2d = kernel
  assert (s - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_ve_score_net_mixed_precision_goes_through_the_fir_kernel(
    cuda_device):
  """The VE net under `model.mixed_precision` on the card: one training
  forward and backward launches kernel 9 once per FIR resampling each way
  and returns finite float32. Each resampling on bfloat16 values, forward
  and backward, is the CPU's plain float32 result rounded once to
  bfloat16, within one bfloat16 step (the float32 sums in another order
  may round to the neighbouring value). The net as a whole is not held
  here: where two orders of a sum round apart, a bfloat16 net carries the
  step on to about its float32-bfloat16 gap (tests/test_torch_bench_flags
  holds it against JAX on the CPU)."""
  from indm_torch.configs import get_config
  from indm_torch.models.registry import create_model
  from indm_torch.ops import upfirdn2d as fir
  from indm_torch.run_lib import set_f32_numerics
  set_f32_numerics()
  cfg = get_config("ve/CIFAR10/indm")
  cfg.data.image_size = 16
  cfg.model.update(nf=16, num_res_blocks=1, ch_mult=(1, 2, 2),
                   attn_resolutions=(8,), init_scale=1.0, dropout=0.0,
                   mixed_precision=True)
  model = create_model(cfg, seed=0, device=cuda_device).train()
  gen = torch.Generator(device=cuda_device).manual_seed(1)
  # the input needs a gradient, as the flow's latent does in a training
  # step: else the pyramid's first FIR has none to take
  x = torch.rand(2, 3, 16, 16, device=cuda_device,
                 generator=gen).requires_grad_()
  sigma = torch.tensor([0.5, 20.0], device=cuda_device)
  f0, b0 = fir.launches, fir.bwd_launches
  out = model(x, sigma)
  out.square().sum().backward()
  torch.cuda.synchronize()
  assert out.dtype == torch.float32 and torch.isfinite(out).all()
  assert (fir.launches - f0, fir.bwd_launches - b0) == (10, 10)

  bf = torch.bfloat16

  def rounded_once(got, want):
    """got (bfloat16) is want (float32) rounded once: within half a
    bfloat16 step (2^-9 of the value; 2^-8 allowed) and 1e-6 of the
    scale, the float32 sums' other order where terms cancel."""
    got, want = got.float().cpu(), want.detach()
    tol = 2.0 ** -8 * want.abs() + 1e-6 * want.abs().max()
    assert ((got - want).abs() <= tol).all()

  h = torch.randn(2, 32, 16, 16, device=cuda_device, generator=gen).to(bf)
  for fn in (fir.upsample_2d, fir.downsample_2d):
    xc = h.detach().requires_grad_()
    xf = h.detach().float().cpu().requires_grad_()
    y, yf = fn(xc, (1, 3, 3, 1)), fn(xf, (1, 3, 3, 1))
    assert y.dtype == bf and yf.dtype == torch.float32
    rounded_once(y, yf)
    ct = torch.randn(y.shape, generator=torch.Generator().manual_seed(2))
    (g,) = torch.autograd.grad(y, xc, ct.to(bf).to(cuda_device))
    (gf,) = torch.autograd.grad(yf, xf, ct.to(bf).float())
    assert g.dtype == bf
    rounded_once(g, gf)


def fused_chain_args(d, preact):
  """Kernel 8's inputs from `fused_inputs`: the forward weights (W1 as
  [I, I]), the biases, the transposed weights in the chain's layout and
  hp."""
  from indm_torch.ops import neumann
  w0, w1, w2 = d["ws"]
  weights_t = [neumann.transpose_conv_weight(w).contiguous()
               for w in (w2, w1, w0)]
  return (d["x"], d["eps"], (w0, w1[:, :, 0, 0]), tuple(d["bs"][:2]),
          weights_t, d["hp"])


@pytest.mark.parametrize("n", [0, 2, 6])
@pytest.mark.parametrize("preact", [True, False])
@pytest.mark.parametrize("geom", FUSED_GEOMS)
def test_fused_chain_kernel_matches_plain(cuda_device, geom, preact, n):
  """Kernel 8 against its plain version (cuDNN convs, TF32 off) and
  against the route it replaces (the diagonals of the plain forward
  through kernel 7) on the same inputs: float32 sums in another order, 1e-4
  of the largest value; one launch per call, its products n + 3 launches
  of the `wgmma` GEMM (layer 1 and one a term) and no other GEMM."""
  import math
  import torch.nn.functional as F
  from indm_torch.flows.resflow import OFFSET_TRAIN, RCDF_TRAIN
  from indm_torch.ops import lipnet_gemm as lg
  from indm_torch.ops import neumann
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  d = fused_inputs(*geom, cond=preact, device=cuda_device)
  x, eps, fwd, biases, weights_t, hp = fused_chain_args(d, preact)
  tail = (n, OFFSET_TRAIN, RCDF_TRAIN, preact)
  before = neumann.fused_launches
  neumann.fused_neumann_chain(x, eps, fwd, biases, weights_t, hp, *tail)
  g0 = lg.device_gemm_launches()
  acc = neumann.fused_neumann_chain(x, eps, fwd, biases, weights_t, hp,
                                    *tail)
  g1 = lg.device_gemm_launches()
  torch.cuda.synchronize()
  assert neumann.fused_launches == before + 2
  assert {k: g1[k] - g0[k] for k in g1} == {
      "gemm_3xtf32": 0, "wgmma": n + OFFSET_TRAIN + 1, "gemm_bf16": 0}
  want = neumann.fused_neumann_chain_plain(x, eps, fwd, biases, weights_t,
                                           hp, *tail)
  assert_close_to_scale([acc], [want])
  s = torch.sin(2 * math.pi * x) / math.pi * 0.5 if preact else x
  z1 = F.conv2d(s, fwd[0], biases[0], padding=1)
  s1 = torch.sin(2 * math.pi * z1) / math.pi * 0.5
  s1 = s1 if hp is None else s1 + hp[:, :, None, None]
  z2 = F.conv2d(s1, d["ws"][1], biases[1])
  dacts = [torch.cos(2 * math.pi * z2), torch.cos(2 * math.pi * z1)]
  if preact:
    dacts.append(torch.cos(2 * math.pi * x))
  k7 = neumann.neumann_chain(eps, dacts, weights_t, n, OFFSET_TRAIN,
                             RCDF_TRAIN)
  assert_close_to_scale([acc], [k7])


def exact_diagonal_chain_args(geom, preact, device, seed=3):
  """Kernel 8's inputs whose diagonals are exact: W0 = W1 = 0, so z1 = b0
  and z2 = b1, with the biases (and x) on multiples of 1/4, where
  cos(2 pi z) is 1, 0 or -1 in any float32 arithmetic; and the same
  diagonals written out for kernel 7. The chain's weights are
  `fused_inputs`' random ones."""
  from indm_torch.ops import neumann
  b, c, h, w, idim = geom
  d = fused_inputs(*geom, cond=True, device=device, seed=seed)
  rng = np.random.default_rng(seed + 1)

  def quarters(*shape):
    return torch.from_numpy(rng.integers(-4, 5, size=shape).astype(
        np.float32) / 4).to(device)

  x, eps, fwd, biases, weights_t, hp = fused_chain_args(d, preact)
  x = quarters(b, c, h, w)
  fwd = tuple(torch.zeros_like(m) for m in fwd)
  biases = (quarters(idim), quarters(idim))
  dacts = [torch.cos(2 * np.pi * bias)[None, :, None, None].expand(
      b, idim, h, w).contiguous() for bias in biases[::-1]]
  if preact:
    dacts.append(torch.cos(2 * np.pi * x))
  dacts = [torch.where(a.abs() < 0.5, torch.zeros_like(a), a.sign())
           for a in dacts]
  return (x, eps, fwd, biases, weights_t, hp), dacts


@pytest.mark.parametrize("preact", [True, False])
@pytest.mark.parametrize("geom", [FUSED_GEOMS[1], FUSED_GEOMS[4],
                                  FUSED_GEOMS[5]])
def test_fused_chain_terms_are_kernel_7_bits(cuda_device, geom, preact):
  """For the same diagonals kernel 8's chain is kernel 7's bit for bit:
  both split W1^T with the same kernel and run the same launches
  (`fused_chain.cu`'s note). The diagonals are made exact (W0 = W1 = 0,
  biases and x on multiples of 1/4: cos 2 pi z in {1, 0, -1}), so that
  both kernels see the same ones."""
  from indm_torch.flows.resflow import OFFSET_TRAIN, RCDF_TRAIN
  from indm_torch.ops import neumann
  args, dacts = exact_diagonal_chain_args(geom, preact, cuda_device)
  for n in (0, 3):
    k8 = neumann.fused_neumann_chain(*args, n, OFFSET_TRAIN, RCDF_TRAIN,
                                     preact)
    k7 = neumann.neumann_chain(args[1], dacts, args[4], n, OFFSET_TRAIN,
                               RCDF_TRAIN)
    assert k8.abs().max() > 0
    assert torch.equal(k8, k7), (k8 - k7).abs().max()


def test_fused_chain_kernel_rejects_unsupported(cuda_device):
  """No fallback on the card: another dtype, a channel count other than 3
  and 12, a non-contiguous input or a wrong shape raise, and launch
  nothing."""
  from indm_torch.ops import neumann
  d = fused_inputs(2, 3, 8, 8, 64, True, cuda_device)
  x, eps, fwd, biases, weights_t, hp = fused_chain_args(d, True)
  c4 = fused_inputs(2, 4, 8, 8, 64, True, cuda_device)
  before = neumann.fused_launches
  for args in ((x.double(), eps, fwd, biases, weights_t, hp),
               (x, eps.transpose(2, 3), fwd, biases, weights_t, hp),
               (x, eps, fwd, biases, weights_t, hp[:, :32].contiguous()),
               fused_chain_args(c4, True)):
    with pytest.raises(ValueError):
      neumann.fused_neumann_chain(*args, 1, 2, [1.0] * 129, True)
  assert neumann.fused_launches == before


@pytest.mark.parametrize("preact", [True, False])
def test_iresblock_fused_chain_goes_through_kernel_8(cuda_device, preact):
  """`IResBlock` with the switch's flag launches kernel 8 once and kernel 7
  never, and gives the log-det and the gradients of the kernel-7 route
  within 1e-4 of their scale."""
  from indm_torch.flows.resflow import IResBlock
  from indm_torch.ops import neumann
  from indm_torch.run_lib import set_f32_numerics
  set_f32_numerics()
  gen = torch.Generator(device=cuda_device).manual_seed(0)
  block = IResBlock(3, 64, cond_dim=16, preact=preact, generator=gen,
                    device=cuda_device)
  x = torch.randn(2, 3, 8, 8, device=cuda_device, generator=gen)
  h = torch.randn(2, 16, device=cuda_device, generator=gen)
  eps = torch.randn(2, 3, 8, 8, device=cuda_device, generator=gen)
  out = {}
  for fused in (True, False):
    block.zero_grad()
    xg = x.clone().requires_grad_()
    f0, k0 = neumann.fused_launches, neumann.launches
    y, ld = block(xg, h, eps, 2, fused_chain=fused)
    ((y * y).sum() + ld.sum()).backward()
    torch.cuda.synchronize()
    assert (neumann.fused_launches - f0, neumann.launches - k0) == (
        (1, 0) if fused else (0, 1))
    out[fused] = [ld.detach(), xg.grad] + [p.grad.clone()
                                           for p in block.parameters()]
  assert_close_to_scale(out[True], out[False])


# (b, cin, cout, h, w): both kinds at small and odd shapes, then the
# benchmark's kinds at batch 4; then conv_out's tiling: wide sides that no
# warp's run of channels or chunk divides (36, 68, 132, 516), odd images
# and images wider than a band (5x7, 17x17, 33x33), batch 1 and 3
NARROW_GEOMS = [(2, 3, 64, 8, 8), (2, 64, 3, 8, 8), (2, 12, 36, 16, 16),
                (2, 36, 12, 16, 16), (1, 3, 68, 5, 7), (1, 68, 12, 5, 7),
                (4, 3, 512, 32, 32), (4, 512, 3, 32, 32),
                (3, 36, 3, 5, 7), (1, 516, 12, 5, 7), (3, 68, 3, 17, 17),
                (1, 132, 12, 17, 17), (1, 132, 3, 33, 33),
                (3, 516, 12, 33, 33), (3, 36, 12, 16, 16),
                (1, 12, 132, 33, 33), (3, 3, 516, 17, 17)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", NARROW_GEOMS)
def test_narrow_conv_kernel_matches_plain(cuda_device, geom, dtype):
  """Kernel 10 against its plain version and `F.conv2d` (TF32 off) on the
  same inputs: float32 within 1e-4 of the largest value (sums in another
  order); bfloat16 within 1e-2 of it (each rounds a float32 sum once to
  bfloat16, one bfloat16 step apart at most); the output in x's type; one
  launch per call."""
  import torch.nn.functional as F
  from indm_torch.ops import narrow_conv as nc
  torch.backends.cudnn.allow_tf32 = False
  b, cin, cout, h, w = geom
  tdt = torch.float32 if dtype == "float32" else torch.bfloat16
  rng = np.random.default_rng(1)
  x = torch.from_numpy(rng.normal(size=(b, cin, h, w)).astype(
      np.float32)).to(cuda_device, tdt)
  wt = torch.from_numpy((0.05 * rng.normal(size=(cout, cin, 3, 3))).astype(
      np.float32)).to(cuda_device, tdt)
  before = nc.launches
  y = nc.narrow_conv(x, wt)
  torch.cuda.synchronize()
  assert nc.launches == before + 1
  assert y.dtype == tdt and tuple(y.shape) == (b, cout, h, w)
  tol = 1e-4 if dtype == "float32" else 1e-2
  for want in (nc.narrow_conv_plain(x, wt), F.conv2d(x, wt, padding=1)):
    assert_close_to_scale([y.float()], [want.float()], tol)


# conv_in through narrow_in (batch, C, I, H, W): both chain scales at
# full width, then W = 8, 16 and 32 with I not a multiple of 128 (nor of
# the 64 channels of a chunk) and images that leave a tile ragged
CONV_IN_GEOMS = [(2, 3, 512, 32, 32), (2, 12, 512, 16, 16),
                 (2, 3, 200, 8, 8), (3, 12, 100, 8, 8),
                 (2, 3, 36, 16, 16), (2, 12, 260, 16, 16),
                 (1, 3, 132, 32, 32), (2, 12, 68, 32, 32),
                 (3, 12, 40, 9, 13)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", CONV_IN_GEOMS)
def test_conv_in_matches_plain(cuda_device, geom, dtype):
  """conv_in (the implicit GEMM on the tensor cores: 3xTF32 in float32,
  bfloat16 `mma.sync` in bfloat16) through narrow_in against the plain
  version and `F.conv2d` (TF32 off): float32 within 1e-4 of the largest
  value, bfloat16 within 1e-2 (one rounding of a float32 sum, one
  bfloat16 step apart at most); float32 also within 1e-5 of the float64
  convolution of the same inputs (the float32 contract, which one TF32
  pass misses); the same bits twice and for a sample alone."""
  import torch.nn.functional as F
  from indm_torch.ops import narrow_conv as nc
  torch.backends.cudnn.allow_tf32 = False
  b, c, idim, h, w = geom
  tdt = torch.float32 if dtype == "float32" else torch.bfloat16
  rng = np.random.default_rng(5)
  x = torch.from_numpy(rng.normal(size=(b, c, h, w)).astype(
      np.float32)).to(cuda_device, tdt)
  wt = torch.from_numpy((rng.normal(size=(idim, c, 3, 3)) / np.sqrt(
      9 * c)).astype(np.float32)).to(cuda_device, tdt)
  y = nc.narrow_conv(x, wt)
  assert y.dtype == tdt and tuple(y.shape) == (b, idim, h, w)
  tol = 1e-4 if dtype == "float32" else 1e-2
  for want in (nc.narrow_conv_plain(x, wt), F.conv2d(x, wt, padding=1)):
    assert_close_to_scale([y.float()], [want.float()], tol)
  if dtype == "float32":
    exact = F.conv2d(x.double(), wt.double(), padding=1)
    assert_close_to_scale([y.double()], [exact], 1e-5)
  assert torch.equal(y, nc.narrow_conv(x, wt))
  assert torch.equal(y[b - 1:], nc.narrow_conv(x[b - 1:].contiguous(), wt))


def test_conv_in_refuses_a_bf16_weight_off_a_word(cuda_device):
  """bfloat16 conv_in at C = 12 copies its weight chunks as 4-byte words:
  a weight that starts on an odd bfloat16 element is refused (CUDA error
  1, invalid value), with no launch and no other path."""
  from indm_torch.ops import narrow_conv as nc
  x = torch.randn(2, 12, 8, 8, device=cuda_device).bfloat16()
  w = torch.randn(64 * 108 + 1, device=cuda_device).bfloat16()
  w = w[1:].view(64, 12, 3, 3)
  assert w.is_contiguous() and w.data_ptr() % 4 == 2
  before = nc.launches
  with pytest.raises(RuntimeError, match="CUDA error 1$"):
    nc.narrow_conv(x, w)
  assert nc.launches == before
  assert nc.narrow_conv(x, w.clone()).shape == (2, 64, 8, 8)


def test_narrow_conv_kernel_rejects_unsupported(cuda_device):
  """No fallback on the card: mixed or other types, a channel count other
  than 3 and 12, a wide side under 33 or a kernel other than 3x3 raise,
  and launch nothing."""
  from indm_torch.ops import narrow_conv as nc
  x = torch.randn(2, 3, 8, 8, device=cuda_device)
  w = torch.randn(64, 3, 3, 3, device=cuda_device)
  before = nc.launches
  for bx, bw in ((x.double(), w.double()), (x, w.bfloat16()),
                 (torch.randn(2, 4, 8, 8, device=cuda_device),
                  torch.randn(64, 4, 3, 3, device=cuda_device)),
                 (x, w[:30].contiguous()), (x, w[:, :, :1, :1].contiguous())):
    with pytest.raises(ValueError):
      nc.narrow_conv(bx, bw)
  assert nc.launches == before


def test_narrow_out_and_chain_give_the_same_bits_twice(cuda_device):
  """conv_out sums in an order fixed by the geometry (each warp its run of
  channels, then the warps in order; no atomics): two calls of narrow_out
  and of the chain at a scale-1-like geometry (C = 12, 16x16, width 512,
  batch 2) give the same bits."""
  from indm_torch.flows.resflow import OFFSET_TRAIN, RCDF_TRAIN
  from indm_torch.ops import narrow_conv as nc
  from indm_torch.ops import neumann
  rng = np.random.default_rng(2)
  x = torch.from_numpy(rng.normal(size=(2, 512, 16, 16)).astype(
      np.float32)).to(cuda_device)
  wt = torch.from_numpy((0.05 * rng.normal(size=(12, 512, 3, 3))).astype(
      np.float32)).to(cuda_device)
  assert torch.equal(nc.narrow_conv(x, wt), nc.narrow_conv(x, wt))
  vareps, dacts, ws = chain_inputs(2, 12, 16, 16, 512, True, cuda_device)
  args = (vareps, dacts, ws, 2, OFFSET_TRAIN, RCDF_TRAIN)
  assert torch.equal(neumann.neumann_chain(*args),
                     neumann.neumann_chain(*args))


# (batch, M, N, K, bt, pairs, shared weight): the main path's four
# products at batch 4 (mat_wide at both scales, the weight shared; the w1
# gradient over two pairs, K = H*W at both scales), then ragged ones: M
# and N not multiples of the 128 x 128 tile, K = 4 * odd, one k-tile or a
# part of one, a single row
GEMM_GEOMS = [(4, 512, 1024, 512, False, 1, True),
              (4, 512, 256, 512, False, 1, True),
              (4, 512, 512, 1024, True, 2, False),
              (4, 512, 512, 256, True, 2, False),
              (3, 200, 84, 36, False, 1, True),
              (3, 200, 84, 36, True, 2, False),
              (2, 20, 12, 100, False, 2, False),
              (2, 130, 132, 4, True, 1, False),
              (5, 1, 4, 12, False, 1, False),
              (2, 129, 260, 44, True, 1, True)]


def gemm_pairs(geom, device, batch=None, seed=0):
  """The product's pairs from numpy: a of variance 1 / K (a weight's
  scale), b of variance 1."""
  b, m, n, k, bt, npairs, shared = geom
  b = batch or b
  rng = np.random.default_rng(seed)

  def t(*shape, scale=1.0):
    return torch.from_numpy((scale * rng.normal(size=shape)).astype(
        np.float32)).to(device)

  a_shape = (m, k) if shared else (b, m, k)
  b_shape = (b, n, k) if bt else (b, k, n)
  return [(t(*a_shape, scale=k ** -0.5), t(*b_shape))
          for _ in range(npairs)]


@pytest.mark.parametrize("geom", GEMM_GEOMS)
def test_lipnet_gemm_kernel_matches_float64(cuda_device, geom):
  """The tensor-core GEMM (3xTF32, float32 accumulation) against the
  float64 product of the same float32 inputs: within 1e-5 of its largest
  value (the float32 contract; one TF32 product misses it, see
  tests/test_torch_lipnet_gemm.py); one launch per call."""
  from indm_torch.ops import lipnet_gemm as lg
  bt = geom[4]
  pairs = gemm_pairs(geom, cuda_device)
  before = lg.launches
  got = lg.lipnet_gemm(pairs, bt=bt)
  torch.cuda.synchronize()
  assert lg.launches == before + 1
  want = sum(torch.matmul(a.double(), (b.transpose(-1, -2) if bt else
                                       b).double()) for a, b in pairs)
  assert got.dtype == torch.float32 and got.shape == want.shape
  assert_close_to_scale([got.double()], [want], 1e-5)


def test_lipnet_gemm_gives_the_same_bits_twice(cuda_device):
  """No split-K and no atomics: two calls of the w1-gradient product (two
  pairs, K = 1024) and of mat_wide give the same bits."""
  from indm_torch.ops import lipnet_gemm as lg
  for geom in (GEMM_GEOMS[2], GEMM_GEOMS[0]):
    pairs = gemm_pairs(geom, cuda_device)
    assert torch.equal(lg.lipnet_gemm(pairs, bt=geom[4]),
                       lg.lipnet_gemm(pairs, bt=geom[4]))


@pytest.mark.parametrize("which", [1, 3])
def test_lipnet_gemm_sample_bits_do_not_depend_on_the_batch(cuda_device,
                                                            which):
  """The tile and the k order depend on (M, N, K, pairs) only: a batch of 6
  and the same two samples alone give the same bits."""
  from indm_torch.ops import lipnet_gemm as lg
  geom = GEMM_GEOMS[which]
  bt, shared = geom[4], geom[6]
  pairs = gemm_pairs(geom, cuda_device, batch=6)
  part = [(a if shared else a[2:4].contiguous(), b[2:4].contiguous())
          for a, b in pairs]
  assert torch.equal(lg.lipnet_gemm(pairs, bt=bt)[2:4],
                     lg.lipnet_gemm(part, bt=bt))


def test_lipnet_gemm_kernel_rejects_unsupported(cuda_device):
  """No fallback on the card: an operand off a 16-byte boundary, K or N
  not a multiple of 4, or another type raise, and launch nothing."""
  from indm_torch.ops import lipnet_gemm as lg
  a = torch.randn(2, 8, 12, device=cuda_device)
  b = torch.randn(2, 12, 8, device=cuda_device)
  off = torch.randn(2 * 8 * 12 + 1, device=cuda_device)[1:].view(2, 8, 12)
  before = lg.launches
  for pairs in ([(off, b)], [(a[:, :, :10].contiguous(), b[:, :10].contiguous())],
                [(a, b[:, :, :6].contiguous())], [(a.double(), b.double())]):
    with pytest.raises(ValueError):
      lg.lipnet_gemm(pairs)
  assert lg.launches == before


# (batch, M, N, K): the forward's two products at batch 4 (W1 and W1^T at
# both scales), then ragged ones: M and N not multiples of the 128 x 128
# tile, K = 4 * odd (a part of a k-tile, a plane row padded to 8), one row,
# N of a partial 32-pixel box
WGMMA_GEOMS = [(4, 512, 1024, 512), (4, 512, 256, 512), (3, 200, 84, 36),
               (2, 129, 260, 44), (5, 1, 4, 12), (2, 64, 36, 1028)]


def wgmma_inputs(geom, device, batch=None, seed=0):
  """w of variance 1 / K (a weight's scale) and act of variance 1."""
  b, m, n, k = geom
  rng = np.random.default_rng(seed)
  w = rng.normal(size=(m, k)) / np.sqrt(k)
  act = rng.normal(size=(batch or b, k, n))
  return (torch.from_numpy(w.astype(np.float32)).to(device),
          torch.from_numpy(act.astype(np.float32)).to(device))


@pytest.mark.parametrize("geom", WGMMA_GEOMS)
def test_lipnet_wgmma_kernel_matches_float64_and_the_mma_gemm(cuda_device,
                                                              geom):
  """The forward's `wgmma` GEMM (3xTF32, the weight split once a call)
  against the float64 product of the same float32 inputs, within 1e-5 of
  its largest value (the float32 contract), against the plain version
  (float32 matmul, TF32 off) and against `gemm_3xtf32_kernel` to the same
  tolerance; one launch per call."""
  from indm_torch.ops import lipnet_gemm as lg
  torch.backends.cuda.matmul.allow_tf32 = False
  w, act = wgmma_inputs(geom, cuda_device)
  before = lg.wgmma_launches
  got = lg.lipnet_wgmma(w, act)
  torch.cuda.synchronize()
  assert lg.wgmma_launches == before + 1
  want = torch.matmul(w.double(), act.double())
  assert got.dtype == torch.float32 and got.shape == want.shape
  assert_close_to_scale([got.double()], [want], 1e-5)
  assert_close_to_scale([got], [lg.lipnet_gemm_plain([(w, act)])], 1e-5)
  assert_close_to_scale([got], [lg.lipnet_gemm([(w, act)])], 1e-5)


def test_lipnet_wgmma_gives_the_same_bits_twice_and_at_any_batch(
    cuda_device):
  """No split-K and no atomics, and the tile order does not touch the sums:
  two calls give the same bits, and so do a batch of 6 and two of its
  samples alone (fewer tiles than SMs, so another schedule)."""
  from indm_torch.ops import lipnet_gemm as lg
  for geom in WGMMA_GEOMS[:3]:
    w, act = wgmma_inputs(geom, cuda_device, batch=6)
    full = lg.lipnet_wgmma(w, act)
    assert torch.equal(full, lg.lipnet_wgmma(w, act))
    assert torch.equal(full[2:4], lg.lipnet_wgmma(w, act[2:4].contiguous()))


def test_lipnet_wgmma_kernel_rejects_unsupported(cuda_device):
  """No fallback on the card: act off a 16-byte boundary, K or N not a
  multiple of 4, another type, or a batched weight raise and launch
  nothing."""
  from indm_torch.ops import lipnet_gemm as lg
  w = torch.randn(8, 12, device=cuda_device)
  act = torch.randn(2, 12, 8, device=cuda_device)
  off = torch.randn(2 * 12 * 8 + 1, device=cuda_device)[1:].view(2, 12, 8)
  before = lg.wgmma_launches
  for args in ((w, off), (w[:, :10].contiguous(), act[:, :10].contiguous()),
               (w, act[:, :, :6].contiguous()), (w.double(), act.double()),
               (w.expand(2, 8, 12).contiguous(), act)):
    with pytest.raises(ValueError):
      lg.lipnet_wgmma(*args)
  assert lg.wgmma_launches == before


def test_kernel_3_runs_its_products_on_the_wgmma_gemm(cuda_device):
  """Kernel 3 at a small size against its plain version (1e-4 of each
  output's largest value, as test_fused_block_kernels_match_plain), with
  its products all `wgmma_3xtf32_kernel` launches (layer 1, n + 2 chain
  terms, J^T u) and none of `gemm_3xtf32_kernel`, as the libraries count
  their launches."""
  from indm_torch.flows.resflow import OFFSET_TRAIN, RCDF_TRAIN
  from indm_torch.ops import fused_block as fb
  from indm_torch.ops import lipnet_gemm as lg
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  n = 2
  d = fused_inputs(2, 3, 8, 8, 64, True, cuda_device)
  args = (d["x"], *d["ws"], *d["bs"], d["hp"], d["eps"], n, OFFSET_TRAIN,
          RCDF_TRAIN, True)
  fb.fused_block_fwd(*args)  # loads the library
  before = lg.device_gemm_launches()
  out = fb.fused_block_fwd(*args)
  after = lg.device_gemm_launches()
  torch.cuda.synchronize()
  assert_close_to_scale(out, fb.fused_block_fwd_plain(*args))
  assert {k: after[k] - before[k] for k in after} == {
      "gemm_3xtf32": 0, "wgmma": n + OFFSET_TRAIN + 2, "gemm_bf16": 0}


# ---- the bfloat16 mode of kernels 3-6 ----

# (batch, M, N, K, bt, pairs, shared weight): the main path's products at
# batch 4, then the tiny net's (width 64, 8x8), then ragged ones: M and N
# not multiples of the 128 x 128 tile, K not a multiple of the 64 of a
# stage (40: a k-tile and a part; 16: half a k-tile), 1-3 pairs either way
BF16_GEMM_GEOMS = [(4, 512, 1024, 512, False, 1, True),
                   (4, 512, 256, 512, False, 2, True),
                   (4, 512, 512, 1024, True, 3, False),
                   (4, 512, 512, 256, True, 3, False),
                   (2, 64, 64, 64, False, 1, True),
                   (2, 64, 64, 64, False, 2, True),
                   (2, 64, 64, 64, True, 3, False),
                   (3, 200, 88, 40, False, 1, True),
                   (3, 200, 88, 40, False, 3, False),
                   (2, 130, 136, 16, True, 2, False),
                   (2, 72, 200, 24, True, 1, True)]


@pytest.mark.parametrize("geom", BF16_GEMM_GEOMS)
def test_lipnet_gemm_bf16_matches_float64(cuda_device, geom):
  """The bfloat16 GEMM against the float64 product of the same bfloat16
  values: within 1e-5 of its largest value (the products are exact in
  float32 and sum in float32, one fresh accumulator a k-tile); one launch
  a call."""
  from indm_torch.ops import lipnet_gemm as lg
  bt = geom[4]
  pairs = [(a.bfloat16(), b.bfloat16())
           for a, b in gemm_pairs(geom, cuda_device)]
  before = lg.bf16_launches
  got = lg.lipnet_gemm_bf16(pairs, bt=bt)
  torch.cuda.synchronize()
  assert lg.bf16_launches == before + 1
  want = sum(torch.matmul(a.double(), (b.transpose(-1, -2) if bt else
                                       b).double()) for a, b in pairs)
  assert got.dtype == torch.float32 and got.shape == want.shape
  assert_close_to_scale([got.double()], [want], 1e-5)
  assert torch.equal(got, lg.lipnet_gemm_bf16(pairs, bt=bt))


def test_lipnet_gemm_bf16_with_a_shared_b_matches_float64(cuda_device):
  """The second operand shared by the batch (a per-batch stride of 0 for
  B), with bt and without: within 1e-5 of the float64 product."""
  from indm_torch.ops import lipnet_gemm as lg
  rng = np.random.default_rng(4)

  def t(*shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        cuda_device, torch.bfloat16)

  for bt in (False, True):
    pairs = [(t(3, 136, 48), t(200, 48) if bt else t(48, 200))
             for _ in range(2)]
    got = lg.lipnet_gemm_bf16(pairs, bt=bt)
    want = sum(torch.matmul(a.double(), (b.t() if bt else b).double())
               for a, b in pairs)
    assert got.shape == (3, 136, 200)
    assert_close_to_scale([got.double()], [want], 1e-5)


@pytest.mark.parametrize("which", [0, 2, 8])
def test_lipnet_gemm_bf16_sample_bits_do_not_depend_on_the_batch(
    cuda_device, which):
  """The tile schedule depends on the batch, the sum order on (M, N, K,
  pairs) only: a batch of 6 and the same two samples alone give the same
  bits, and two calls the same bits."""
  from indm_torch.ops import lipnet_gemm as lg
  geom = BF16_GEMM_GEOMS[which]
  bt, shared = geom[4], geom[6]
  pairs = [(a.bfloat16(), b.bfloat16())
           for a, b in gemm_pairs(geom, cuda_device, batch=6)]
  part = [(a if shared else a[2:4].contiguous(), b[2:4].contiguous())
          for a, b in pairs]
  whole = lg.lipnet_gemm_bf16(pairs, bt=bt)
  assert torch.equal(whole, lg.lipnet_gemm_bf16(pairs, bt=bt))
  assert torch.equal(whole[2:4], lg.lipnet_gemm_bf16(part, bt=bt))


def test_lipnet_gemm_bf16_rejects_unsupported(cuda_device):
  from indm_torch.ops import lipnet_gemm as lg
  a = torch.zeros(4, 12, device=cuda_device, dtype=torch.bfloat16)
  b = torch.zeros(2, 12, 16, device=cuda_device, dtype=torch.bfloat16)
  before = lg.bf16_launches
  for pairs in ([(a, b)], [(a.float(), b.float())], [(a, b)] * 4):
    with pytest.raises(ValueError):
      lg.lipnet_gemm_bf16(pairs)
  assert lg.bf16_launches == before


def f64(a):
  """a in float64: a tensor, or each tensor of a list or tuple."""
  if torch.is_tensor(a):
    return a.double()
  if isinstance(a, (list, tuple)):
    return type(a)(f64(t) for t in a)
  return a


def exact(plain, *args, compute_dtype=torch.float32):
  """A plain version of kernels 3-8 in float64: the rounding points of
  `compute_dtype` kept, every other sum exact (float32 cuDNN convs may run
  as FFTs, whose error reaches a good part of the float32-bfloat16 gap)."""
  return plain(*(f64(a) for a in args), compute_dtype)


def exact_stack_fwd(out, args, compute_dtype=torch.float32):
  """Kernel 5's (y, ld_all, u_all) exactly, block by block: block j's plain
  version in float64 (`exact`) on the kernel's own carry xs_all[j], as
  the backward's references take the kernel's xs_all. Returns (ys_all
  [n, B, C, H, W], ld_all, u_all), ys_all[j] block j's output. Against a
  stack in float64 from x alone, a carry that rounds to the other side of
  a bfloat16 value in one block differs by that value's ulp in every later
  block, as any two implementations whose float32 sums run in another
  order do."""
  from indm_torch.ops import fused_block as fb
  _, w0s, w1s, w2s, b0s, b1s, b2s, hp_all, eps_all, n_all, *rest = args
  per = [exact(fb.fused_block_fwd_plain, out[3][j], w0s[j], w1s[j], w2s[j],
               b0s[j], b1s[j], b2s[j], None if hp_all is None else hp_all[j],
               eps_all[j], n, *rest, compute_dtype=compute_dtype)
         for j, n in enumerate(n_all)]
  return [torch.stack(t) for t in zip(*per)]


def assert_bf16_close(got, want16, want32, name):
  """The card's bfloat16 mode against the exact plain bfloat16 and float32
  versions: the CPU test's tolerance (`tests/test_torch_bf16.py`), closer
  to the plain bfloat16 than half of its gap to float32 and within 2e-2 of
  the scale."""
  for i, (g, r, f) in enumerate(zip(got, want16, want32)):
    if r is None:
      assert g is None
      continue
    err = (g - r).abs().max().item()
    gap = (f - r).abs().max().item()
    assert err <= 2e-2 * f.abs().max().item(), (name, i, err)
    assert err < 0.5 * gap, (name, i, err, gap)


# full width at batch 8: a log-det is one value a sample, and one sample's
# error and its float32-bfloat16 gap are two independent rounding sums, so
# at batch 1 their ratio passes half now and then for a right kernel
BF16_FUSED_GEOMS = [(2, 3, 8, 8, 64), (2, 12, 8, 8, 40), (3, 3, 16, 16, 136),
                    (8, 3, 32, 32, 512), (8, 12, 16, 16, 512),
                    (8, 12, 32, 32, 512)]


@pytest.mark.parametrize("n", [0, 3])
@pytest.mark.parametrize("preact", [True, False])
@pytest.mark.parametrize("geom", BF16_FUSED_GEOMS)
def test_fused_block_kernels_bf16_match_plain(cuda_device, geom, preact, n):
  """Kernels 3 and 4 in bfloat16 against their exact plain bfloat16
  versions on the card; all 1x1 products on the bfloat16 GEMM,
  n + 4 a forward and 5 a backward; kernel 4 twice gives the same bits."""
  from indm_torch.flows.resflow import OFFSET_TRAIN, RCDF_TRAIN
  from indm_torch.ops import fused_block as fb
  from indm_torch.ops import lipnet_gemm as lg
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  bf = torch.bfloat16
  d = fused_inputs(*geom, cond=preact, device=cuda_device)
  args = (d["x"], *d["ws"], *d["bs"], d["hp"], d["eps"], n, OFFSET_TRAIN,
          RCDF_TRAIN, preact)
  g0 = lg.device_gemm_launches()
  out = fb.fused_block_fwd(*args, bf)
  torch.cuda.synchronize()
  g1 = lg.device_gemm_launches()
  assert g1["gemm_bf16"] - g0["gemm_bf16"] == n + 2 + 2
  assert (g1["wgmma"], g1["gemm_3xtf32"]) == (g0["wgmma"], g0["gemm_3xtf32"])
  assert_bf16_close(out, exact(fb.fused_block_fwd_plain, *args,
                              compute_dtype=bf),
                    exact(fb.fused_block_fwd_plain, *args), "fwd")
  bargs = (d["x"], d["eps"], out[2], d["ybar"], d["lbar"], *d["ws"],
           *d["bs"][:2], d["hp"], preact)
  grads = fb.fused_block_bwd(*bargs, bf)
  torch.cuda.synchronize()
  assert lg.device_gemm_launches()["gemm_bf16"] - g1["gemm_bf16"] == 5
  assert_bf16_close(grads, exact(fb.fused_block_bwd_plain, *bargs,
                                compute_dtype=bf),
                    exact(fb.fused_block_bwd_plain, *bargs), "bwd")
  again = fb.fused_block_bwd(*bargs, bf)
  assert all(g is None and a is None or torch.equal(g, a)
             for g, a in zip(grads, again))


def test_fused_block_kernels_bf16_reject_unsupported(cuda_device):
  """A width that is a multiple of 4 but not of 8 is refused in bfloat16
  and taken in float32."""
  from indm_torch.flows.resflow import OFFSET_TRAIN, RCDF_TRAIN
  from indm_torch.ops import fused_block as fb
  d = fused_inputs(2, 12, 8, 8, 36, cond=True, device=cuda_device)
  args = (d["x"], *d["ws"], *d["bs"], d["hp"], d["eps"], 1, OFFSET_TRAIN,
          RCDF_TRAIN, True)
  before = fb.fwd_launches
  with pytest.raises(ValueError, match="multiple of 8"):
    fb.fused_block_fwd(*args, torch.bfloat16)
  assert fb.fwd_launches == before
  fb.fused_block_fwd(*args)
  assert fb.fwd_launches == before + 1


BF16_STACK_GEOMS = [(2, 3, 8, 8, 64, 3), (2, 12, 8, 8, 40, 2),
                    (8, 3, 32, 32, 512, 3), (8, 12, 16, 16, 512, 2),
                    (8, 12, 32, 32, 512, 2)]


@pytest.mark.parametrize("cond", [True, False])
@pytest.mark.parametrize("geom", BF16_STACK_GEOMS)
def test_fused_stack_kernels_bf16_match_plain_and_looped_pair(cuda_device,
                                                               geom, cond):
  """Kernels 5 and 6 in bfloat16 against their exact plain bfloat16
  versions (the forward block by block on its own carry,
  `exact_stack_fwd`), and against kernels 3 and 4 in bfloat16 looped over
  the same blocks: the same bits."""
  from indm_torch.flows.resflow import OFFSET_TRAIN, RCDF_TRAIN
  from indm_torch.ops import fused_block as fb
  from indm_torch.ops import fused_stack as fs
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  bf = torch.bfloat16
  d = stack_inputs(*geom, cond=cond, device=cuda_device)
  args = (d["x"], *d["ws"], *d["bs"], d["hp"], d["eps"], d["n_all"],
          OFFSET_TRAIN, RCDF_TRAIN, True)
  out = fs.fused_stack_fwd(*args, bf)
  y, ld_all, u_all, xs_all = out
  assert torch.equal(xs_all[0], d["x"])
  assert_bf16_close((torch.cat([xs_all[1:], y[None]]), ld_all, u_all),
                    exact_stack_fwd(out, args, bf),
                    exact_stack_fwd(out, args), "fwd")
  bargs = (xs_all, d["eps"], u_all, d["ybar"], d["lbar"], *d["ws"],
           *d["bs"][:2], d["hp"], True)
  grads = fs.fused_stack_bwd(*bargs, bf)
  assert_bf16_close(grads, exact(fs.fused_stack_bwd_plain, *bargs,
                                compute_dtype=bf),
                    exact(fs.fused_stack_bwd_plain, *bargs), "bwd")
  x = d["x"]
  for j, n in enumerate(d["n_all"]):
    assert torch.equal(xs_all[j], x)
    x, ld, u = fb.fused_block_fwd(
        x, *(_slice(t, j) for t in d["ws"] + d["bs"]), _slice(d["hp"], j),
        _slice(d["eps"], j), n, OFFSET_TRAIN, RCDF_TRAIN, True, bf)
    assert torch.equal(ld_all[j], ld) and torch.equal(u_all[j], u)
  assert torch.equal(y, x)
  cot = d["ybar"]
  for j in reversed(range(len(d["n_all"]))):
    cot, *per_block = fb.fused_block_bwd(
        _slice(xs_all, j), _slice(d["eps"], j), _slice(u_all, j), cot,
        d["lbar"], *(_slice(t, j) for t in d["ws"] + d["bs"][:2]),
        _slice(d["hp"], j), True, bf)
    assert all(g is None and s is None or torch.equal(s[j], g)
               for s, g in zip(grads[1:], per_block))
  assert torch.equal(grads[0], cot)


# the chain's bfloat16 mode (kernels 7 and 8): full width at batch 8, as
# BF16_FUSED_GEOMS, since the float32-bfloat16 gap of a tiny chain is a
# few roundings and one rounding that lands on the other side moves acc by
# most of it
BF16_CHAIN_GEOMS = [(8, 3, 32, 32, 512), (8, 12, 16, 16, 512),
                    (8, 12, 32, 32, 512)]


def bf16_chain_args(geom, preact, device):
  """Kernel 7's inputs in bfloat16 (`chain_inputs` rounded) and kernel 8's
  (`fused_chain_args` rounded, hp included)."""
  bf = torch.bfloat16
  vareps, dacts, ws = chain_inputs(*geom, preact, device)
  k7 = (vareps.to(bf), [d.to(bf) for d in dacts], [w.to(bf) for w in ws])
  d = fused_inputs(*geom, cond=True, device=device)
  x, eps, fwd, biases, weights_t, hp = fused_chain_args(d, preact)
  k8 = (x.to(bf), eps.to(bf), tuple(w.to(bf).contiguous() for w in fwd),
        tuple(b.to(bf) for b in biases), [w.to(bf) for w in weights_t],
        hp.to(bf))
  return k7, k8


@pytest.mark.parametrize("n", [0, 3])
@pytest.mark.parametrize("preact", [True, False])
@pytest.mark.parametrize("geom", BF16_CHAIN_GEOMS)
def test_chain_kernels_bf16_match_plain(cuda_device, geom, preact, n):
  """Kernels 7 and 8 in bfloat16 against their plain bfloat16 versions on
  float64 inputs (every rounding point kept, every other sum exact), the
  plain float32 versions giving the gap: the largest error within 2e-2 of
  the scale, the mean square error under a quarter of the mean square gap
  (one element rounded to the neighbouring bfloat16 value by another order
  of a float32 sum costs a whole step there, and later terms carry it, so
  the largest error is no measure; chip_smoke.py's check_bf16_chain); one
  call,
  counted apart from the float32 calls; every product on the bfloat16
  GEMM (kernel 7: n + 2, kernel 8: n + 3), no other GEMM."""
  from indm_torch.flows.resflow import OFFSET_TRAIN, RCDF_TRAIN
  from indm_torch.ops import lipnet_gemm as lg
  from indm_torch.ops import neumann
  bf = torch.bfloat16
  tail = (n, OFFSET_TRAIN, RCDF_TRAIN)
  k7, k8 = bf16_chain_args(geom, preact, cuda_device)
  for name, fn, plain, args, gemms in (
      ("neumann_chain", neumann.neumann_chain, neumann.neumann_chain_plain,
       (*k7, *tail), n + 2),
      ("fused_neumann_chain", neumann.fused_neumann_chain,
       neumann.fused_neumann_chain_plain, (*k8, *tail, preact), n + 3)):
    counts = (neumann.launches, neumann.bf16_launches, neumann.fused_launches,
              neumann.fused_bf16_launches)
    g0 = lg.device_gemm_launches()
    acc = fn(*args)
    torch.cuda.synchronize()
    g1 = lg.device_gemm_launches()
    assert acc.dtype == torch.float32
    got = (neumann.launches, neumann.bf16_launches, neumann.fused_launches,
           neumann.fused_bf16_launches)
    want = list(counts)
    want[1 if name == "neumann_chain" else 3] += 1
    assert list(got) == want, name
    assert g1["gemm_bf16"] - g0["gemm_bf16"] == gemms, name
    assert (g1["wgmma"], g1["gemm_3xtf32"]) == (g0["wgmma"],
                                                g0["gemm_3xtf32"]), name
    want16 = exact(plain, *args, compute_dtype=bf)
    want32 = exact(plain, *args)
    diff, gaps = (acc - want16).abs(), (want32 - want16).abs()
    assert diff.max() <= 2e-2 * want32.abs().max(), name
    assert diff.pow(2).mean() < 0.25 * gaps.pow(2).mean(), name


@pytest.mark.parametrize("preact", [True, False])
@pytest.mark.parametrize("geom", [(8, 48, 16, 16, 512), (2, 48, 8, 8, 64)])
def test_chain_kernel_bf16_at_48_channels_matches_plain(cuda_device, geom,
                                                        preact):
  """Kernel 7 in bfloat16 at 48 channels (CelebA's second flow scale on
  the chain route under bench.py's flags: conv_in's K in six groups of 8
  channels in bfloat16) against its plain bfloat16 version on float64
  inputs at n = 0 and 3, as `test_chain_kernels_bf16_match_plain` holds
  it; n + 2 bfloat16 GEMMs; the same bits twice."""
  from indm_torch.flows.resflow import OFFSET_TRAIN, RCDF_TRAIN
  from indm_torch.ops import lipnet_gemm as lg
  from indm_torch.ops import neumann
  bf = torch.bfloat16
  vareps, dacts, ws = chain_inputs(*geom, preact, cuda_device)
  args = (vareps.to(bf), [d.to(bf) for d in dacts], [w.to(bf) for w in ws])
  for n in (0, 3):
    tail = (n, OFFSET_TRAIN, RCDF_TRAIN)
    g0 = lg.device_gemm_launches()
    acc = neumann.neumann_chain(*args, *tail)
    torch.cuda.synchronize()
    assert lg.device_gemm_launches()["gemm_bf16"] - g0["gemm_bf16"] == n + 2
    want16 = exact(neumann.neumann_chain_plain, *args, *tail,
                   compute_dtype=bf)
    want32 = exact(neumann.neumann_chain_plain, *args, *tail)
    diff, gaps = (acc - want16).abs(), (want32 - want16).abs()
    assert diff.max() <= 2e-2 * want32.abs().max()
    assert diff.pow(2).mean() < 0.25 * gaps.pow(2).mean()
    assert torch.equal(acc, neumann.neumann_chain(*args, *tail))


def test_chain_kernels_bf16_reject_unsupported(cuda_device):
  """A width that is a multiple of 4 but not of 8, or float32 and
  bfloat16 inputs mixed, are refused in bfloat16 and launch nothing."""
  from indm_torch.ops import neumann
  k7, k8 = bf16_chain_args((2, 12, 8, 8, 36), True, cuda_device)
  before = (neumann.bf16_launches, neumann.fused_bf16_launches)
  with pytest.raises(ValueError, match="multiples of 8"):
    neumann.neumann_chain(*k7, 1, 2, [1.0] * 129)
  with pytest.raises(ValueError, match="multiples of 8"):
    neumann.fused_neumann_chain(*k8, 1, 2, [1.0] * 129, True)
  k7, k8 = bf16_chain_args((2, 12, 8, 8, 64), True, cuda_device)
  with pytest.raises(ValueError, match="bfloat16"):
    neumann.neumann_chain(k7[0], [d.float() for d in k7[1]], k7[2], 1, 2,
                          [1.0] * 129)
  with pytest.raises(ValueError, match="bfloat16"):
    neumann.fused_neumann_chain(k8[0], k8[1].float(), *k8[2:], 1, 2,
                                [1.0] * 129, True)
  assert (neumann.bf16_launches, neumann.fused_bf16_launches) == before


@pytest.mark.parametrize("fused", [False, True])
def test_iresblock_chain_bf16_goes_through_the_bf16_kernels(cuda_device,
                                                            fused):
  """The chain route of `IResBlock` in bfloat16 (flow.mixed_precision)
  launches kernel 7 or, with the switch's flag, kernel 8 once in
  bfloat16 and no float32 chain; its log-det and x's gradient are within
  2e-2 of the float32 block's scale, every gradient finite."""
  from indm_torch.flows.resflow import IResBlock
  from indm_torch.ops import neumann
  from indm_torch.run_lib import set_f32_numerics
  set_f32_numerics()
  gen = torch.Generator(device=cuda_device).manual_seed(0)
  block = IResBlock(3, 64, cond_dim=16, preact=True, generator=gen,
                    device=cuda_device)
  x = torch.randn(2, 3, 8, 8, device=cuda_device, generator=gen)
  h = torch.randn(2, 16, device=cuda_device, generator=gen)
  eps = torch.randn(2, 3, 8, 8, device=cuda_device, generator=gen)
  out = {}
  for bf16 in (True, False):
    block.compute_dtype = torch.bfloat16 if bf16 else torch.float32
    block.mixed_precision = bf16
    block.zero_grad()
    xg = x.clone().requires_grad_()
    before = (neumann.launches, neumann.bf16_launches,
              neumann.fused_launches, neumann.fused_bf16_launches)
    y, ld = block(xg, h, eps, 2, fused_chain=fused)
    ((y * y).sum() + ld.sum()).backward()
    torch.cuda.synchronize()
    counts = [a - b for a, b in zip(
        (neumann.launches, neumann.bf16_launches, neumann.fused_launches,
         neumann.fused_bf16_launches), before)]
    want = [0, 0, 0, 0]
    want[2 * fused + bf16] = 1
    assert counts == want, (bf16, fused, counts)
    assert all(torch.isfinite(p.grad).all() for p in block.parameters())
    out[bf16] = [ld.detach(), xg.grad]
  assert_close_to_scale(out[True], out[False], tol=2e-2)


# the other score nets' rows (DDPM's min(32, C) groups; the 256-pixel
# NCSN++'s 256x256 planes): (n, c, h, w, num_groups, act)
GN_NET_GEOMS = [
    (4, 128, 32, 32, 32, "swish"),     # DDPM: 4 channels a row
    (4, 512, 4, 4, 32, "none"),        # DDPM's middle attention
    (2, 128, 256, 256, 32, "swish"),   # 262 144 values a row
    (1, 256, 256, 256, 32, "swish"),   # 524 288 values a row
    (2, 256, 128, 128, 32, "none"),
]


@pytest.mark.parametrize("geom", GN_NET_GEOMS)
def test_group_norm_kernels_at_the_other_nets_rows(cuda_device, geom):
  """Kernels 1 and 2 at the DDPM and 256-pixel NCSN++ rows against their
  plain versions (forward 1e-5; backward 1e-4 of the largest value); the
  long rows take the backward's one-block-a-row kernel."""
  n, c, h, w, g, act = geom
  rng = np.random.default_rng(8)

  def t(*shape, loc=0.0, scale=1.0):
    return torch.from_numpy(rng.normal(loc, scale, size=shape).astype(
        np.float32)).to(cuda_device)

  x, dy = t(n, c, h, w, loc=0.5, scale=1.5), t(n, c, h, w)
  scale, bias = t(c, loc=1.0, scale=0.2), t(c, scale=0.2)
  if h * w >= 128 * 128:
    assert gn.bwd_plan(c, h * w, g, 4, True) == (0, 0)
  before = (gn.launches, gn.bwd_launches)
  y = gn.group_norm_act(x, scale, bias, g, act=act)
  got = gn.group_norm_act_backward(x, dy, scale, bias, g, act=act)
  torch.cuda.synchronize()
  assert (gn.launches, gn.bwd_launches) == (before[0] + 1, before[1] + 1)
  torch.testing.assert_close(y, gn.group_norm_act_plain(x, scale, bias, g,
                                                         act=act),
                             atol=1e-5, rtol=1e-5)
  ref = gn.group_norm_act_backward_plain(x, dy, scale, bias, g, act=act)
  for a, want in zip(got, ref):
    big = want.abs().max().item()
    torch.testing.assert_close(a, want, atol=1e-4 * big, rtol=1e-4)


# the 256-pixel NCSN++'s FIR calls at batch 1: (C, H, W, up, down, pad);
# its planes of 128x128 and 256x256 pass the shared memory a block takes
# without an opt-in, so the tile kernel runs them
FIR_256_CALLS = [
    (3, 256, 256, 1, 2, (1, 1)),      # input_skip's pyramid
    (3, 128, 128, 2, 1, (2, 1)),      # output_skip's pyramid
    (128, 256, 256, 1, 2, (1, 1)),    # a down block's h and x
    (128, 128, 128, 2, 1, (2, 1)),    # an up block's
    (128, 128, 128, 1, 2, (1, 1)),
    (256, 64, 64, 1, 2, (1, 1)),
]


@pytest.mark.parametrize("call", FIR_256_CALLS)
def test_upfirdn2d_at_the_256_pixel_net_calls(cuda_device, call):
  """Kernel 9 forward and backward at the 256-pixel net's calls against
  the plain version (1e-5 of the largest value; the backward against
  autograd of the plain version on float64 inputs)."""
  from indm_torch.ops import upfirdn2d as fir
  c, h, w, up, down, pad = call
  k = fir.setup_kernel([1, 3, 3, 1]) * (4.0 if up == 2 else 1.0)
  oh = fir.out_size(h, 4, up, down, pad)
  assert (fir.plane_plan(c, h, w, oh, oh) == 0) == (h >= 128)
  rng = np.random.default_rng(9)
  x = torch.from_numpy(rng.normal(size=(1, c, h, w)).astype(
      np.float32)).to(cuda_device)
  _check_fir(fir, x, k, up, down, pad)
  xg = x.clone().requires_grad_(True)
  before = fir.bwd_launches
  y = fir.upfirdn2d(xg, k, up, down, pad)
  dy = torch.from_numpy(rng.normal(size=tuple(y.shape)).astype(
      np.float32)).to(cuda_device)
  (dx,) = torch.autograd.grad(y, xg, dy)
  torch.cuda.synchronize()
  assert fir.bwd_launches == before + 1
  x64 = x.double().requires_grad_(True)
  (want,) = torch.autograd.grad(fir.upfirdn2d_plain(x64, k, up, down, pad),
                                x64, dy.double())
  assert (dx.double() - want).abs().max().item() <= \
      1e-5 * want.abs().max().item()


@pytest.mark.parametrize("leaves", [
    {"model.name": "ddpm"}, {"model.resblock_type": "ddpm"},
    {"model.progressive": "output_skip", "model.progressive_input":
     "input_skip", "model.fir": True, "model.nonlinearity": "elu"}],
    ids=["ddpm", "ncsnpp_ddpm_blocks", "ncsnpp_pyramids_elu"])
def test_other_score_nets_go_through_the_kernels(cuda_device, leaves):
  """A small DDPM and NCSN++ branches on the card: one training forward
  and backward launches kernels 1 and 2 once for each GroupNorm of the net
  (and kernel 9 as its FIR calls ask), the evaluation within 1e-5 of the
  same net through the plain versions."""
  from indm_torch import sde as sde_lib
  from indm_torch.configs import get_config
  from indm_torch.models import layers
  from indm_torch.models.registry import create_model, get_score_fn
  from indm_torch.ops import upfirdn2d as fir
  from indm_torch.run_lib import set_f32_numerics
  set_f32_numerics()
  cfg = get_config("vp/CIFAR10/indm_nll")
  cfg.data.image_size = 16
  cfg.model.update(nf=32, num_res_blocks=1, ch_mult=(1, 2),
                   attn_resolutions=(8,), init_scale=1.0,
                   fused_groupnorm=True, dropout=0.0, **{
                       k.split(".")[1]: v for k, v in leaves.items()})
  model = create_model(cfg, seed=0, device=cuda_device)
  # seeded noise on every weight: DDPM's init-scale-0 convs start at
  # ~1e-10, and a wrong GroupNorm inside its blocks would not reach the
  # output
  noise = torch.Generator().manual_seed(2)
  with torch.no_grad():
    for p in model.parameters():
      p.add_(0.05 * torch.randn(p.shape, generator=noise).to(p.device))
  norms = sum(isinstance(m, layers.GroupNorm) for m in model.modules())
  score_fn = get_score_fn(cfg, sde_lib.get_sde(cfg), model,
                          differentiable=True)
  gen = torch.Generator(device=cuda_device).manual_seed(1)
  x = torch.randn(2, 3, 16, 16, device=cuda_device, generator=gen)
  t = torch.full((2,), 0.4, device=cuda_device)
  before = (gn.launches, gn.bwd_launches, fir.launches)
  model.train().requires_grad_(True)
  score_fn(x, t).square().sum().backward()
  torch.cuda.synchronize()
  assert (gn.launches - before[0], gn.bwd_launches - before[1]) == (
      norms, norms)
  assert (fir.launches > before[2]) == bool(cfg.model.fir)
  model.eval()
  with torch.no_grad():
    s = score_fn(x, t)
    kernels = (gn.group_norm_act, fir.upfirdn2d)
    gn.group_norm_act, fir.upfirdn2d = (gn.group_norm_act_plain,
                                        fir.upfirdn2d_plain)
    try:
      want = score_fn(x, t)
    finally:
      gn.group_norm_act, fir.upfirdn2d = kernels
  assert (s - want).abs().max().item() <= 1e-5 * want.abs().max().item()
