"""The port's fused-stack pair (`indm_torch.ops.fused_stack`), the flow's
stack route and the training step that runs it, against the JAX package.

The JAX side runs as `test_fused_stack.py` runs it: `fused_stack_apply` and
`fused_stack_fwd_pallas` with cfg (offset 2, pre-activated, "float32",
interpret), and `fused_stack_reference`, at that test's geometry (width 64,
8x8, batch 32, 3 blocks) and tolerances, for C = 3 and 12, with hp and
without. The port's wrappers take their plain versions on these CPU
tensors; the CUDA kernels are held against the plain versions and against
kernels 3 and 4 looped by `test_torch_cuda.py` and `chip_smoke.py`.
Weights of variance 1/fan_in keep every term of the chain of order one at
both channel counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train_step as tts
from indm_torch.flows import resflow as torch_resflow
from indm_torch.ops import fused_block as pfb
from indm_torch.ops import fused_stack as pfs
from indm_torch.ops import neumann
from indm_tpu.flows.resflow import _poisson_rcdf_table
from indm_tpu.ops import fused_block as jfb
from indm_tpu.ops import fused_stack as jfs
from test_fused_stack import _assert_close_scaled
from test_torch_fused_block import _count_calls
from torch_threads import one_torch_thread  # noqa: F401

OFFSET = 2
TABLE = _poisson_rcdf_table(2.0, OFFSET)
IDIM, HW, B, NB = 64, 8, 32, 3
CFG = (OFFSET, True, "float32", True)   # interpret mode, float32
CASES = [(3, True), (3, False), (12, True), (12, False)]   # (C, hp)


def _inputs(c, cond, seed=0):
  """NHWC x, stacked NHWC noise, stacked HWIO weights of variance 1/fan_in,
  biases, hp_all and n_all, from numpy."""
  rng = np.random.default_rng(seed)

  def w(*shape):
    return (rng.normal(size=(NB,) + shape)
            / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)

  ws = (w(3, 3, c, IDIM), w(1, 1, IDIM, IDIM), w(3, 3, IDIM, c))
  bs = tuple((0.1 * rng.normal(size=(NB, n))).astype(np.float32)
             for n in (IDIM, IDIM, c))
  hp = ((0.3 * rng.normal(size=(NB, B, IDIM))).astype(np.float32)
        if cond else None)
  x = rng.normal(size=(B, HW, HW, c)).astype(np.float32)
  eps = rng.normal(size=(NB, B, HW, HW, c)).astype(np.float32)
  n_all = rng.integers(0, 4, (NB,)).astype(np.int32)
  return x, ws, bs, hp, eps, n_all


def _oihw(w):
  """Stacked HWIO [n, kh, kw, I, O] -> stacked OIHW [n, O, I, kh, kw]."""
  return torch.from_numpy(np.ascontiguousarray(w.transpose(0, 4, 3, 1, 2)))


def _stacked_nchw(a):
  return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 1, 4, 2, 3)))


def _stacked_nhwc(t):
  return t.detach().permute(0, 1, 3, 4, 2).numpy()


def _port_args(x, ws, bs, hp, eps, n_all):
  """The port's stack arguments, in `fused_stack_fwd` order."""
  return (tts._nchw(x), *map(_oihw, ws), *map(torch.from_numpy, bs),
          None if hp is None else torch.from_numpy(hp), _stacked_nchw(eps),
          [int(n) for n in n_all], OFFSET, TABLE, True)


def _jax(a):
  return None if a is None else jnp.asarray(a)


def _jax_apply(x, ws, bs, hp, eps, n_all):
  return jfs.fused_stack_apply(CFG, _jax(x), *map(_jax, ws), *map(_jax, bs),
                               _jax(hp), _jax(eps), _jax(n_all),
                               _jax(TABLE))


@pytest.mark.parametrize("c,cond", CASES)
def test_plain_forward_matches_fused_stack_apply(c, cond):
  """(y, sum of the log-dets) of `fused_stack_fwd` on CPU tensors (the plain
  version; no launch) against `fused_stack_apply` in interpret mode, at
  `test_fused_stack.py:83-86`'s tolerances: y rtol 1e-4 atol 2e-5, the
  log-det sum rtol 1e-3 atol 1e-4 (the kernel's polynomial sin/cos)."""
  inputs = _inputs(c, cond)
  pfs.reset_launches()
  y, ld_all, _, _ = pfs.fused_stack_fwd(*_port_args(*inputs))
  assert pfs.fwd_launches == 0
  y_j, ld_j = _jax_apply(*inputs)
  np.testing.assert_allclose(tts._nhwc(y), np.asarray(y_j), rtol=1e-4,
                             atol=2e-5)
  np.testing.assert_allclose(ld_all.sum(0).numpy(), np.asarray(ld_j),
                             rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("c,cond", CASES)
def test_plain_forward_matches_reference(c, cond):
  """The plain stack forward against `fused_stack_reference` (the jnp loop
  of `fused_block_reference`): y and the log-det sum to 1e-5."""
  x, ws, bs, hp, eps, n_all = _inputs(c, cond, seed=1)
  y, ld_all, _, _ = pfs.fused_stack_fwd_plain(
      *_port_args(x, ws, bs, hp, eps, n_all))
  y_r, ld_r = jfs.fused_stack_reference(
      _jax(x), tuple(map(_jax, ws)), tuple(map(_jax, bs)), _jax(hp),
      _jax(eps), _jax(n_all), TABLE, OFFSET, True)
  np.testing.assert_allclose(tts._nhwc(y), np.asarray(y_r), rtol=1e-5,
                             atol=1e-5)
  np.testing.assert_allclose(ld_all.sum(0).numpy(), np.asarray(ld_r),
                             rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c,cond", CASES)
def test_plain_residuals_match_pallas_kernel(c, cond):
  """u_all, xs_all and each block's log-det of the plain stack forward
  against `fused_stack_fwd_pallas(interpret=True)`, the residuals the
  backward reads, at the y and log-det tolerances above."""
  x, ws, bs, hp, eps, n_all = _inputs(c, cond)
  _, ld_all, u_all, xs_all = pfs.fused_stack_fwd_plain(
      *_port_args(x, ws, bs, hp, eps, n_all))
  packed = jfs._pack_all(*map(_jax, ws), jnp.float32)
  _, ld_k, u_k, xs_k = jfs.fused_stack_fwd_pallas(
      _jax(x), _jax(eps), _jax(n_all), _jax(TABLE), *packed,
      *map(_jax, bs), _jax(hp), offset=OFFSET, preact=True,
      compute_dtype=jnp.float32, interpret=True)
  np.testing.assert_allclose(_stacked_nhwc(xs_all), np.asarray(xs_k),
                             rtol=1e-4, atol=2e-5)
  np.testing.assert_allclose(_stacked_nhwc(u_all), np.asarray(u_k),
                             rtol=1e-4, atol=2e-5)
  np.testing.assert_allclose(ld_all.numpy(), np.asarray(ld_k), rtol=1e-3,
                             atol=1e-4)


@pytest.mark.parametrize("c,cond", CASES)
def test_plain_backward_matches_jax_grad(c, cond):
  """The eight gradients of `fused_stack_bwd` on CPU tensors for
  sum(y * wy) + sum(ld * wl) against `jax.grad` through
  `fused_stack_apply` (interpret), with `_assert_close_scaled` at 5e-5
  (`test_fused_stack.py:118-119`)."""
  x, ws, bs, hp, eps, n_all = _inputs(c, cond, seed=3)
  rng = np.random.default_rng(9)
  wy = rng.normal(size=x.shape).astype(np.float32)
  wl = rng.normal(size=(B,)).astype(np.float32)
  args = _port_args(x, ws, bs, hp, eps, n_all)
  _, _, u_all, xs_all = pfs.fused_stack_fwd_plain(*args)
  pfs.reset_launches()
  got = pfs.fused_stack_bwd(xs_all, args[8], u_all, tts._nchw(wy),
                            torch.from_numpy(wl), *args[1:6], args[7], True)
  assert pfs.bwd_launches == 0
  assert (got[-1] is None) == (hp is None)

  def loss(xx, w0, w1, w2, b0, b1, b2, hh):
    y, ld = jfs.fused_stack_apply(CFG, xx, w0, w1, w2, b0, b1, b2, hh,
                                  _jax(eps), _jax(n_all), _jax(TABLE))
    return jnp.sum(y * wy) + jnp.sum(ld * wl)

  argnums = tuple(range(7)) + ((7,) if cond else ())
  want = jax.grad(loss, argnums)(_jax(x), *map(_jax, ws), *map(_jax, bs),
                                 _jax(hp))
  port = [tts._nhwc(got[0])]
  port += [g.permute(0, 3, 4, 2, 1).numpy() for g in got[1:4]]
  port += [g.numpy() for g in got[4:7]]
  names = ["x", "w0", "w1", "w2", "b0", "b1", "b2"]
  if cond:
    port.append(got[7].numpy())
    names.append("hp")
  for name, a, b in zip(names, port, want):
    _assert_close_scaled(a, b, name)


@pytest.mark.parametrize(
    "cond,dtype", [(True, torch.float32), (False, torch.float32),
                   (True, torch.bfloat16), (False, torch.bfloat16)],
    ids=["True", "False", "True-bf16", "False-bf16"])
def test_fused_stack_fn_matches_fused_block_fn_looped(cond, dtype):
  """`FusedStackFn` against `FusedBlockFn` applied block by block on the
  same inputs (the route that INDM_FUSED_STACK=0 takes), in float32 and in
  the bfloat16 mode: y, the log-det sum and every gradient, 1e-5 (the
  log-dets are summed in another order)."""
  args = list(_port_args(*_inputs(3, cond, seed=4)))
  leaves = [0, 1, 2, 3, 4, 5, 6] + ([7] if cond else [])
  rng = np.random.default_rng(5)
  r = torch.from_numpy(rng.normal(size=(B, 3, HW, HW)).astype(np.float32))
  q = torch.from_numpy(rng.normal(size=(B,)).astype(np.float32))

  def run(stacked):
    a = [t.clone().requires_grad_() if i in leaves else t
         for i, t in enumerate(args)]
    if stacked:
      y, ld = pfs.FusedStackFn.apply(*a, dtype)
    else:
      y, ld = a[0], 0.0
      for j, n in enumerate(a[9]):
        y, ld_j = pfb.FusedBlockFn.apply(
            y, *(t[j] for t in a[1:7]), None if a[7] is None else a[7][j],
            a[8][j], n, OFFSET, TABLE, True, dtype)
        ld = ld + ld_j
    ((y * r).sum() + (ld * q).sum()).backward()
    return [y.detach(), ld.detach()] + [a[i].grad for i in leaves]

  for got, want in zip(run(True), run(False)):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def _flow_grads(flow, x, h, noise, switch, monkeypatch):
  monkeypatch.setenv("INDM_FUSED_STACK", switch)
  flow.zero_grad()
  xx, hh = x.clone().requires_grad_(), h.clone().requires_grad_()
  z, logpx = flow.fwdpass(xx, hh, noise)
  (0.1 * (z * torch.cos(z)).sum() + 0.7 * logpx.sum()).backward()
  return {"z": z.detach(), "logpx": logpx.detach(), "x": xx.grad,
          "h": hh.grad, **{k: p.grad.clone()
                           for k, p in flow.named_parameters()}}


def test_flow_stack_route_matches_per_block_route(monkeypatch):
  """A `ResidualFlow((3, 2))` at width 64 with `fused_block`: the stack
  route (the switch unset: one stack per scale, the first block through
  the fused pair) against INDM_FUSED_STACK=0 (every block through the
  fused pair), values and the gradients of x, h and every parameter, 1e-5.
  The modules and their state_dict keys are those of the chain route."""
  flow = torch_resflow.ResidualFlow(
      8, 3, n_blocks=(3, 2), intermediate_dim=IDIM, cond_dim=16,
      generator=torch.Generator().manual_seed(0), fused_block=True)
  assert [b.stack_ok() for b in flow.blocks()] == [False] + [True] * 4
  plain = torch_resflow.ResidualFlow(8, 3, n_blocks=(3, 2),
                                     intermediate_dim=IDIM, cond_dim=16)
  assert list(flow.state_dict()) == list(plain.state_dict())
  assert "transforms.1.chain.1.nnet.3.h_net.net.weight" in flow.state_dict()
  x = torch.randn(4, 3, 8, 8, generator=torch.Generator().manual_seed(1))
  h = torch.randn(4, 16, generator=torch.Generator().manual_seed(2))
  noise = flow.sample_noise(x.shape, torch.Generator().manual_seed(3),
                            np.random.default_rng(4))
  counts = {name: _count_calls(monkeypatch, mod, name) for mod, name in (
      (pfs, "fused_stack_fwd"), (pfs, "fused_stack_bwd"),
      (pfb, "fused_block_fwd"), (pfb, "fused_block_bwd"))}
  got = _flow_grads(flow, x, h, noise, "1", monkeypatch)
  assert [len(v) for v in counts.values()] == [2, 2, 1, 1]
  for v in counts.values():
    v.clear()
  want = _flow_grads(flow, x, h, noise, "0", monkeypatch)
  assert [len(v) for v in counts.values()] == [0, 0, 5, 5]
  assert set(got) == set(want)
  for k in want:
    np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5,
                               atol=1e-6, err_msg=k)


def test_build_hashes_the_shared_headers(tmp_path, monkeypatch):
  """Both fused sources include the per-block device code and the
  Lipschitz net's (its `wgmma` GEMMs, float32 and bfloat16, in headers of
  their own), and an edit of any of the four headers renames (so
  rebuilds) the stack's library."""
  import shutil
  from indm_torch.ops import build
  for source in ("fused_block.cu", "fused_stack.cu"):
    assert build._source_files(source) == [source, "fused_block_ops.cuh",
                                           "lipnet_ops.cuh",
                                           "lipnet_wgmma.cuh",
                                           "lipnet_wgmma_bf16.cuh"]
  shutil.copytree(build.SOURCE_DIR, tmp_path / "csrc")
  monkeypatch.setattr(build, "SOURCE_DIR", tmp_path / "csrc")
  before = build.library_path("fused_stack.cu")
  for header in ("fused_block_ops.cuh", "lipnet_ops.cuh",
                 "lipnet_wgmma.cuh", "lipnet_wgmma_bf16.cuh"):
    with open(tmp_path / "csrc" / header, "a") as f:
      f.write("// edited\n")
    after = build.library_path("fused_stack.cu")
    assert after != before
    before = after


# ---- the whole joint step, nblocks "3-2", the switch unset ----

STACK_STEP = {"flow.intermediate_dim": IDIM, "flow.fused_block": True,
              "flow.nblocks": "3-2"}


@pytest.fixture(scope="module")
def stack_setup():
  """The JAX step at width 64 with `flow.fused_block=True` and
  `nblocks="3-2"`, INDM_FUSED_STACK unset (read when the step is traced):
  both scales have a scanned stack of two blocks. Counts the calls of
  `fused_stack_apply` and `fused_block_apply` while the step is traced."""
  with pytest.MonkeyPatch.context() as mp:
    mp.delenv("INDM_FUSED_STACK", raising=False)
    stack_calls = _count_calls(mp, jfs, "fused_stack_apply")
    block_calls = _count_calls(mp, jfb, "fused_block_apply")
    gen = tts.jax_step_setup(STACK_STEP)
    s = next(gen)
    s["jax_calls"] = (len(stack_calls), len(block_calls))
    yield s
    next(gen, None)


@pytest.fixture(scope="module")
def stack_port_step(stack_setup):
  with pytest.MonkeyPatch.context() as mp:
    mp.delenv("INDM_FUSED_STACK", raising=False)
    names = [(pfs, "fused_stack_fwd_plain"), (pfs, "fused_stack_bwd_plain"),
             (pfb, "fused_block_fwd"), (pfb, "fused_block_bwd"),
             (neumann, "neumann_chain")]
    calls = [_count_calls(mp, mod, name) for mod, name in names]
    out = tts.run_port_step(stack_setup)
  return out, tuple(len(c) for c in calls)


def test_stack_step_took_the_stack_route(stack_setup, stack_port_step):
  """Both sides ran the stack route: the JAX step traced
  `fused_stack_apply` for the stack of each scale and `fused_block_apply`
  for the first block; the port ran the plain stack forward and backward
  twice, the fused pair once and no separate chain."""
  assert stack_setup["jax_calls"] == (2, 1)
  assert stack_port_step[1] == (2, 2, 1, 1, 0)


def test_stack_step_losses_match(stack_setup, stack_port_step):
  """Per-example losses and their three terms to 1e-4, as
  `test_torch_train_step.py` holds them."""
  _, _, aux = stack_port_step[0]
  for name, want in zip(tts.torch_joint.METRICS, stack_setup["metrics"]):
    np.testing.assert_allclose(aux[name].detach().numpy(), want, rtol=1e-4,
                               atol=1e-4, err_msg=name)


def test_stack_step_gradients_match(stack_setup, stack_port_step):
  """Both nets' gradients before any update: rtol 1e-4, atol 1e-5."""
  n = 0
  for name, p, want in tts._grad_pairs(stack_setup, stack_port_step[0]):
    assert p.grad is not None, name
    np.testing.assert_allclose(p.grad.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5, err_msg=name)
    n += 1
  assert n > 100
