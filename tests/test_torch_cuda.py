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


# (b, c, h, w, idim): small shapes, then one sample of each full-width scale
FUSED_GEOMS = [(2, 3, 8, 8, 64), (2, 12, 8, 8, 36), (3, 3, 16, 16, 132),
               (1, 3, 32, 32, 512), (1, 12, 16, 16, 512)]


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
               (1, 3, 32, 32, 512, 3), (1, 12, 16, 16, 512, 2)]


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
  of the largest value; one launch per call."""
  import math
  import torch.nn.functional as F
  from indm_torch.flows.resflow import OFFSET_TRAIN, RCDF_TRAIN
  from indm_torch.ops import neumann
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  d = fused_inputs(*geom, cond=preact, device=cuda_device)
  x, eps, fwd, biases, weights_t, hp = fused_chain_args(d, preact)
  tail = (n, OFFSET_TRAIN, RCDF_TRAIN, preact)
  before = neumann.fused_launches
  acc = neumann.fused_neumann_chain(x, eps, fwd, biases, weights_t, hp,
                                    *tail)
  torch.cuda.synchronize()
  assert neumann.fused_launches == before + 1
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
# benchmark's kinds at batch 4
NARROW_GEOMS = [(2, 3, 64, 8, 8), (2, 64, 3, 8, 8), (2, 12, 36, 16, 16),
                (2, 36, 12, 16, 16), (1, 3, 68, 5, 7), (1, 68, 12, 5, 7),
                (4, 3, 512, 32, 32), (4, 512, 3, 32, 32)]


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
