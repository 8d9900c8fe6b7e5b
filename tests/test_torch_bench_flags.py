"""The flags of the JAX package's benchmark (`bench.py:56-80`) on the VE and
CelebA configs, in the port against the JAX package: the VE score net under
`model.mixed_precision` (its FIR resampling in bfloat16), kernel 7's
plain version in bfloat16 at 48 channels (CelebA's second flow scale on
the chain route), the fused pair's and stack's plain versions at CelebA's
first flow scale (12 channels on 32x32), a tiny `ve/CELEBA/indm` step
under the flags, and the kernels' checks at every block geometry the six
shipped configs reach.

The JAX side runs as `tests/test_torch_bf16.py` runs it: the Pallas
kernels in interpret mode, compiled with `xla_allow_excess_precision` off
where the port follows the bfloat16 roundings one by one, the float32
result on the same inputs as the scale of what bfloat16 changes. Weights
cross over through `indm_torch.convert`; every draw of the JAX step is
replayed; the VE net takes XLA's bits of log sigma, as in
`tests/test_torch_celeba.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_celeba as tcel
import test_torch_conv_in as tci
import test_torch_neumann as tn
import test_torch_train_step as tts
from indm_torch import configs as torch_configs
from indm_torch import convert
from indm_torch import joint as torch_joint
from indm_torch import sde as torch_sde
from indm_torch.flows import flow_model as torch_fm
from indm_torch.models import ncsnpp as torch_ncsnpp
from indm_torch.models.ncsnpp import NCSNpp
from indm_torch.ops import fused_block as pfb
from indm_torch.ops import fused_stack as pfs
from indm_torch.ops import neumann
from indm_torch.ops import upfirdn2d as fir
from indm_tpu import configs as jax_configs
from indm_tpu import joint as jax_joint
from indm_tpu import sde as jax_sde
from indm_tpu import state as jax_state
from indm_tpu.flows import flow_model as jax_fm
from indm_tpu.models import create_model as jax_create_model
from indm_tpu.ops import fused_block as jfb
from indm_tpu.ops import fused_stack as jfs
from indm_tpu.flows.resflow import _poisson_rcdf_table
from indm_tpu.ops import neumann_pallas
from test_torch_bf16 import BOUND, STRICT, _close, _strict
from test_torch_celeba import tiny_preset  # noqa: F401  (autouse)
from test_torch_neumann import _nchw, _nhwc
from torch_threads import one_torch_thread  # noqa: F401

BF16 = torch.bfloat16
TABLE = _poisson_rcdf_table(2.0, tn.OFFSET)
CONFIGS = ("vp/CIFAR10/indm_nll", "vp/CIFAR10/indm_fid", "ve/CIFAR10/indm",
           "vp/CELEBA/indm_nll", "vp/CELEBA/indm_fid", "ve/CELEBA/indm")
# bench.py's flags: the fused route, the flow's kernels in bfloat16, the
# score net in mixed precision, GroupNorm without the kernel
BENCH_FLAGS = {"flow.fused_block": True, "flow.logdet_bf16": True,
               "flow.mixed_precision": True, "model.mixed_precision": True,
               "model.fast_dropout": True, "model.fused_groupnorm": False}
F32_FLAGS = {**BENCH_FLAGS, "flow.logdet_bf16": False,
             "flow.mixed_precision": False, "model.mixed_precision": False}
# the tiny VE net of tests/test_torch_ve.py
SCORE_TINY = {"data.image_size": 16, "model.nf": 16,
              "model.num_res_blocks": 1, "model.ch_mult": (1, 2),
              "model.attn_resolutions": (8,), "model.init_scale": 1.0}


def _configs(name, overrides):
  jc, tc = jax_configs.get_config(name), torch_configs.get_config(name)
  for k, v in overrides.items():
    tts._set(jc, k, v)
    tts._set(tc, k, v)
  return jc, tc


# ---- the VE score net under model.mixed_precision ----

@pytest.mark.parametrize("name", ["ve/CIFAR10/indm", "ve/CELEBA/indm"])
def test_ve_net_mixed_precision_matches_jax(name):
  """The VE net under `model.mixed_precision` against the JAX net under the
  same flag, on the same weights and inputs (train mode, dropout 0): the
  output, float32, within 2e-2 of its largest value
  (`tests/test_models.py:61`) and not the float32 net's. The gradients of
  sum(out * r) with respect to every parameter: the largest error at most
  twice the largest difference between JAX's own float32 and bfloat16
  nets (the bound of `test_torch_bf16.test_bench_step_gradients_match`).
  2e-2 of the largest gradient is not a bound a bfloat16 net meets here:
  at sigma 0.05 (the output divided by sigma) JAX's eager and strictly
  compiled bfloat16 nets differ by 4.7 % of it, its float32 net by 7.5 %,
  and the port by 3.0 %. Its FIR resampling took the plain version of
  kernel 9 in float32, rounded into and out of it (no launch on the
  CPU)."""
  jc, tc = _configs(name, {**SCORE_TINY, "model.mixed_precision": True,
                           "model.dropout": 0.0})
  module, variables = jax_create_model(jc, jax.random.PRNGKey(0))
  tree = tts._np(variables)
  net = NCSNpp(tc).train()
  net.load_state_dict(convert.score_state_dict_from_jax(
      tree["params"], tc, tree["buffers"]), strict=True)
  rng = np.random.default_rng(5)
  x = rng.uniform(0, 1, size=(2, 16, 16, 3)).astype(np.float32)
  sigma = np.asarray([0.05, 30.0], np.float32)
  r = rng.normal(size=x.shape).astype(np.float32)
  buffers = {k: v for k, v in variables.items() if k != "params"}

  def loss(params):
    out = module.apply({"params": params, **buffers}, jnp.asarray(x),
                       jnp.asarray(sigma), train=True)
    return jnp.sum(out * jnp.asarray(r)), out

  (_, want), grads = jax.value_and_grad(loss, has_aux=True)(
      variables["params"])
  want = np.asarray(want)
  module32, _ = jax_create_model(
      _configs(name, {**SCORE_TINY, "model.dropout": 0.0})[0],
      jax.random.PRNGKey(0))
  grads32 = jax.grad(lambda p: jnp.sum(module32.apply(
      {"params": p, **buffers}, jnp.asarray(x), jnp.asarray(sigma),
      train=True) * jnp.asarray(r)))(variables["params"])
  fir.reset_launches()
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(torch_ncsnpp, "torch", tcel._XlaLog())
    got = net(_nchw(x), torch.from_numpy(sigma))
  (got * _nchw(r)).sum().backward()
  assert got.dtype == torch.float32 and fir.launches == 0
  scale = np.abs(want).max()
  assert np.abs(_nhwc(got.detach()) - want).max() <= BOUND * scale
  net32 = NCSNpp(_configs(name, {**SCORE_TINY, "model.dropout": 0.0})[1])
  net32.load_state_dict(net.state_dict())
  with torch.no_grad():
    f32 = net32.train()(_nchw(x), torch.from_numpy(sigma))
  assert np.abs(_nhwc(got.detach() - f32)).max() > 1e-4 * scale
  g_want, g32 = (convert.score_state_dict_from_jax(tts._np(g), tc,
                                                   tree["buffers"])
                 for g in (grads, grads32))
  named = dict(net.named_parameters())
  assert set(named) <= set(g_want) and len(named) > 100
  err = max((p.grad - g_want[k]).abs().max().item()
            for k, p in named.items())
  gap = max((g32[k] - g_want[k]).abs().max().item() for k in named)
  assert gap > 0 and err <= 2 * gap, (err, gap)


def test_fir_rounds_bf16_in_and_out():
  """A bfloat16 input to the FIR resampling: the float32 plain version on
  the same values with the taps rounded to bfloat16, rounded once to
  bfloat16; the gradient flows back in bfloat16."""
  x = torch.randn(2, 4, 8, 8).to(BF16).requires_grad_()
  for fn in (fir.upsample_2d, fir.downsample_2d):
    y = fn(x, (1, 3, 3, 1), factor=2)
    want = fn(x.detach().float(), (1, 3, 3, 1), factor=2).to(BF16)
    assert y.dtype == BF16 and torch.equal(y, want)
    (g,) = torch.autograd.grad(y.float().sum(), x)
    assert g.dtype == BF16 and torch.isfinite(g.float()).all()
  k = np.asarray([[0.1, 0.2], [0.3, 0.4]], np.float32)
  k16 = torch.from_numpy(k).to(BF16).float().numpy()
  assert not np.array_equal(k16, k)
  assert torch.equal(fir._resample(x.detach(), k, pad=(1, 0)),
                     fir.upfirdn2d(x.detach().float(), k16,
                                   pad=(1, 0)).to(BF16))


# ---- kernel 7 in bfloat16 at 48 channels ----

@pytest.mark.parametrize("n", [0, 2, 5])
@pytest.mark.parametrize("preact,cond", tn.CASES)
def test_chain_plain_bf16_at_48_channels_matches_ref(preact, cond, n):
  """`neumann_chain` on bfloat16 inputs at 48 channels (the plain version
  on the CPU: CelebA's second flow scale on the chain route under the
  flags), and the plain version in float64, against `neumann_chain_ref`
  and `neumann_chain_pallas` (interpret) in bfloat16 on the JAX net's
  bfloat16 `chain_mats`, with `test_torch_bf16._close`."""
  nnet, params, _, x, h, eps = tn._setup(preact, cond, in_ch=48, idim=32,
                                         hw=4)
  hj = None if h is None else jnp.asarray(h)
  wt16, d16 = nnet.chain_mats(params, jnp.asarray(x), h=hj,
                              dtype=jnp.bfloat16)
  wt32, d32 = nnet.chain_mats(params, jnp.asarray(x), h=hj)
  e16 = jnp.asarray(eps).astype(jnp.bfloat16)
  nj, table = jnp.asarray(n, jnp.int32), jnp.asarray(TABLE)
  r16 = _strict(lambda e, d, w: neumann_pallas.neumann_chain_ref(
      e, d, w, nj, tn.OFFSET, table))(e16, d16, wt16)
  j16 = _strict(lambda e, d, w: neumann_pallas.neumann_chain_pallas(
      e, d, w, nj, tn.OFFSET, table, preact=preact, interpret=True))(
          e16, d16, wt16)
  j32 = neumann_pallas.neumann_chain_ref(jnp.asarray(eps), d32, wt32, nj,
                                         tn.OFFSET, table)

  def t(a, perm):
    return torch.from_numpy(np.array(jnp.asarray(a).astype(
        jnp.float32)).transpose(perm).copy()).to(BF16)

  args = ([t(d, (0, 3, 1, 2)) for d in d16],
          [t(w, (3, 2, 0, 1)) for w in wt16])
  neumann.reset_launches()
  neumann._check(t(e16, (0, 3, 1, 2)), *args)
  acc = neumann.neumann_chain(t(e16, (0, 3, 1, 2)), *args, n, tn.OFFSET,
                              TABLE)
  assert (neumann.launches, neumann.bf16_launches) == (0, 0)
  assert acc.dtype == torch.float32 and tuple(acc.shape) == (4, 48, 4, 4)
  acc64 = neumann.neumann_chain_plain(
      t(e16, (0, 3, 1, 2)).double(), [d.double() for d in args[0]],
      [w.double() for w in args[1]], n, tn.OFFSET, TABLE, BF16)
  _close("acc ref", _nhwc(acc), r16, j32)
  _close("acc pallas", _nhwc(acc), j16, j32)
  _close("acc float64", _nhwc(acc64), r16, j32)


# ---- the fused pair and stack at CelebA's first flow scale ----

PAIR_B, PAIR_IDIM, PAIR_C, PAIR_HW = 2, 64, 12, 32


def _pair_inputs(cond, seed=0, nb=None):
  """NHWC x and vareps at 12 x 32 x 32, HWIO weights of variance 1/fan_in
  (with `nb`, stacked, and vareps a stack), biases and hp, from numpy."""
  rng = np.random.default_rng(seed)
  lead = () if nb is None else (nb,)
  c, idim = PAIR_C, PAIR_IDIM

  def w(*shape):
    return (rng.normal(size=lead + shape)
            / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)

  ws = (w(3, 3, c, idim), w(1, 1, idim, idim), w(3, 3, idim, c))
  bs = tuple((0.1 * rng.normal(size=lead + (k,))).astype(np.float32)
             for k in (idim, idim, c))
  hp = ((0.3 * rng.normal(size=lead + (PAIR_B, idim))).astype(np.float32)
        if cond else None)
  x = rng.normal(size=(PAIR_B, PAIR_HW, PAIR_HW, c)).astype(np.float32)
  eps = rng.normal(size=lead + x.shape).astype(np.float32)
  return x, ws, bs, hp, eps


def _oihw(w):
  return torch.from_numpy(np.ascontiguousarray(
      np.moveaxis(w, (-1, -2), (-4, -3))))


def _jnp(a):
  return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("preact,cond", tn.CASES)
def test_fused_pair_plain_at_12x32x32_matches_reference(preact, cond):
  """(y, logdet) of `fused_block_fwd` at 12 channels on 32x32 (the plain
  version on the CPU; batch 2, width 64) against `fused_block_reference`
  at `tests/test_torch_fused_block.py`'s tolerances (y 1e-5, logdet 1e-4);
  its backward is finite and the kernels' check takes the geometry."""
  n = 2
  x, ws, bs, hp, eps = _pair_inputs(cond)
  args = (_nchw(x), *map(_oihw, ws), *map(torch.from_numpy, bs),
          None if hp is None else torch.from_numpy(hp), _nchw(eps))
  pfb._check(args[0], *args[1:6], args[7], b2=args[6],
             narrow=[("vareps", args[8])])
  pfb.reset_launches()
  y, ld, u = pfb.fused_block_fwd(*args, n, tn.OFFSET, TABLE, preact)
  assert pfb.fwd_launches == 0
  y_r, ld_r = jfb.fused_block_reference(
      jnp.asarray(x), tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)),
      _jnp(hp), jnp.asarray(eps), n, TABLE, tn.OFFSET, preact)
  np.testing.assert_allclose(_nhwc(y), np.asarray(y_r), rtol=1e-5, atol=1e-5)
  np.testing.assert_allclose(ld.numpy(), np.asarray(ld_r), rtol=1e-4,
                             atol=1e-4)
  grads = pfb.fused_block_bwd(args[0], args[8], u, torch.ones_like(y),
                              torch.ones_like(ld), *args[1:6], args[7],
                              preact)
  assert all(g is None or torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("cond", [True, False])
def test_fused_stack_plain_at_12x32x32_matches_reference(cond):
  """A stack of three pre-activated blocks at 12 channels on 32x32 through
  `fused_stack_fwd` (the plain version on the CPU) against
  `fused_stack_reference`: y and the log-det sum to 1e-5
  (`tests/test_torch_fused_stack.py`)."""
  nb = 3
  x, ws, bs, hp, eps = _pair_inputs(cond, seed=1, nb=nb)
  n_all = [1, 0, 3]
  args = (_nchw(x), *map(_oihw, ws), *map(torch.from_numpy, bs),
          None if hp is None else torch.from_numpy(hp),
          torch.from_numpy(np.ascontiguousarray(eps.transpose(0, 1, 4, 2,
                                                              3))),
          n_all, tn.OFFSET, TABLE, True)
  pfs.reset_launches()
  y, ld_all, _, _ = pfs.fused_stack_fwd(*args)
  assert pfs.fwd_launches == 0
  y_r, ld_r = jfs.fused_stack_reference(
      jnp.asarray(x), tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)),
      _jnp(hp), jnp.asarray(eps), jnp.asarray(n_all), TABLE, tn.OFFSET, True)
  np.testing.assert_allclose(_nhwc(y), np.asarray(y_r), rtol=1e-5, atol=1e-5)
  np.testing.assert_allclose(ld_all.sum(0).numpy(), np.asarray(ld_r),
                             rtol=1e-5, atol=1e-5)


# ---- the kernels' checks at every geometry the six configs reach ----

def _empty(shape, dtype=torch.float32):
  """An uninitialised CPU tensor (its pages are never touched)."""
  return torch.empty(shape, dtype=dtype)


@pytest.mark.parametrize("name", CONFIGS)
def test_kernel_checks_take_every_block_of_the_configs(name):
  """Every iResBlock of the config at full width and its training batch,
  under `flow.fused_block=true` (bench.py's first flag) in float32 and in
  bfloat16: a block the JAX package sends to the fused kernels
  (in_ch < 33 <= width) passes the checks of kernels 3-6 (its scale's
  stack too) and of kernel 8; every block passes kernel 7's. A 48-channel
  block is refused by the fused kernels, naming the switch, as the JAX
  package routes it to kernel 7. These are the checks the wrappers run on
  a CUDA tensor before any launch."""
  cfg = torch_configs.get_config(name)
  cfg.flow.fused_block = True
  fm = torch_fm.FlowModel(cfg, device="meta")
  b, c, hw = (cfg.training.batch_size, cfg.data.num_channels,
              cfg.data.image_size)
  if fm.squeeze:
    c, hw = 4 * c, hw // 2
  idim = cfg.flow.intermediate_dim
  assert (b, idim) == (128, 512)
  blocks = fm.resflow.blocks()
  shapes = fm.resflow.block_shapes((b, c, hw, hw))
  fused_shapes = set()
  for dtype in (torch.float32, BF16):
    for block, (_, ch, h, w) in zip(blocks, shapes):
      nd = 3 if block.preact else 2
      wt = [_empty(s, dtype) for s in ((idim, ch, 3, 3), (idim, idim, 1, 1),
                                       (ch, idim, 3, 3))]
      dacts = [_empty(s, dtype) for s in ((b, idim, h, w), (b, idim, h, w),
                                          (b, ch, h, w))][:nd]
      neumann._check(_empty((b, ch, h, w), dtype), dacts, wt)
      x = _empty((b, ch, h, w))
      ws = [_empty(s) for s in ((idim, ch, 3, 3), (idim, idim, 1, 1),
                                (ch, idim, 3, 3))]
      bs = [_empty((idim,)), _empty((idim,)), _empty((ch,))]
      hp = _empty((b, idim))
      if not block.fused_ok():
        assert ch == 48
        with pytest.raises(ValueError, match="flow.fused_block"):
          pfb._check(x, *ws, *bs[:2], hp, b2=bs[2], compute_dtype=dtype)
        continue
      fused_shapes.add((ch, h, w))
      pfb._check(x, *ws, *bs[:2], hp, b2=bs[2], narrow=[("vareps", x)],
                 compute_dtype=dtype)
      pfb._check(x, *ws, *bs[:2], hp, lbar=_empty((b,)),
                 narrow=[("vareps", x), ("u", x), ("ybar", x)],
                 compute_dtype=dtype)
      if block.stack_ok():
        nb = sum(o.stack_ok() and s == (b, ch, h, w)
                 for o, s in zip(blocks, shapes))
        stacked = [_empty((nb,) + tuple(t.shape)) for t in ws + bs + [hp]]
        pfs._check(x, nb, *stacked[:5], stacked[6], b2s=stacked[5],
                   n_all=[2] * nb,
                   stacked=[("vareps_all", _empty((nb, b, ch, h, w)))],
                   compute_dtype=dtype)
      fwd = (ws[0].to(dtype), ws[1][:, :, 0, 0].to(dtype))
      neumann._check_fused(x.to(dtype), x.to(dtype), fwd,
                           [t.to(dtype) for t in bs[:2]], wt, hp.to(dtype))
  want = {(3, 32, 32), (12, 16, 16)} if "CIFAR" in name else {(12, 32, 32)}
  assert fused_shapes == want


def test_conv_in_48_channel_groups_fit_in_bf16():
  """conv_in at 48 channels in bfloat16 (kernel 7 at CelebA's second flow
  scale on the chain route under the flags): float32's six groups of 8
  channels, K = 72 a group padded to the `mma`'s 80, rows of 88 for
  `ldmatrix`, one weight tile filled through registers; the group's
  im2col and weight tiles, the staging and the halo within an SM's shared
  memory, with room for two blocks."""
  k = tci._constants("lipnet_ops.cuh")
  text = (tci.CSRC / "lipnet_ops.cuh").read_text()
  assert "kAsync = kBf16 && KC % 2 == 0 && kGroups == 1" in text
  pixels, chunk, halo = k["kConvPixels"], k["kOcChunk"], k["kMaxHalo"]
  kc = 9 * 8
  kp = (kc + 15) // 16 * 16
  s = kp + 8
  assert (kp, s) == (80, 88) and s * 2 % 16 == 0 and s * 2 // 16 % 2 == 1
  assert 8 % 2 == 0  # two threads a pixel take four channels each
  smem = (pixels * s * 2 + chunk * s * 2 + chunk * (pixels + 8) * 4
          + 48 * halo * 4)
  assert smem == 107776 and 2 * (smem + 1024) <= tci.SMEM


# ---- a tiny ve/CELEBA/indm step under the flags ----

VE = "ve/CELEBA/indm"
# CelebA's tiny geometry (tests/test_torch_celeba.py) at width 64: the
# squeezed 8x8x12 scale takes the fused kernels (the first block's pair,
# a stack of two), the 4x4x48 scale kernel 7 (two blocks)
STEP_TINY = {**tcel.TINY, "flow.intermediate_dim": 64, "flow.nblocks": "3-2"}


def _jax_ve_step(flags):
  """`step_nll` of `ve/CELEBA/indm` at STEP_TINY under `flags` in JAX with
  gradient-recording optimizers, compiled strictly; the port's models on
  its weights; its metrics and gradients."""
  jc, tc = tcel.configs(VE, {**STEP_TINY, **flags})
  module, variables = jax_create_model(jc, jax.random.PRNGKey(0))
  buffers = {k: v for k, v in variables.items() if k != "params"}
  fm = jax_fm.create_flow_model(jc)
  f_params, f_buffers = fm.init(jax.random.PRNGKey(1))
  opt = tts._record_grads()
  ss = jax_state.init_train_state(jc, variables["params"], buffers, opt,
                                  jax.random.PRNGKey(2))
  fs = jax_state.init_train_state(jc, f_params, f_buffers, opt,
                                  jax.random.PRNGKey(3))
  step = jax_joint.make_joint_step_fn(jc, jax_sde.get_sde(jc), module, fm,
                                      opt, opt, train=True)
  batch = np.random.default_rng(4).uniform(0, 1, tcel.SHAPE).astype(
      np.float32)
  (ss2, fs2), metrics = jax.jit(step, compiler_options=STRICT)(
      (ss, fs), jnp.asarray(batch))
  tree = tts._np(variables)
  score = NCSNpp(tc)
  score.load_state_dict(convert.score_state_dict_from_jax(
      tree["params"], tc, tree["buffers"]), strict=True)
  flow = torch_fm.FlowModel(tc)
  flow.load_state_dict(convert.flow_state_dict_from_jax(
      tts._np(f_params), tc, tts._np(f_buffers["batch_stats"])), strict=True)
  grads = {**convert.score_state_dict_from_jax(
      tts._np(ss2.opt_state["g"]), tc, tree["buffers"]),
           **convert.flow_state_dict_from_jax(tts._np(fs2.opt_state["g"]),
                                              tc)}
  return dict(tc=tc, fm=fm, f_params=f_params, f_buffers=f_buffers, ss=ss,
              score=score.train(), flow=flow.train(), batch=batch,
              metrics=[np.asarray(m) for m in metrics], grads=grads)


@pytest.fixture(scope="module")
def ve_step():
  """The JAX step under bench.py's flags and under the same flags with the
  three precision switches off (the float32 control, whose distance is
  the scale of what bfloat16 changes); the port's step under the flags on
  the first's weights, batch and draws, its kernels' plain versions
  watched."""
  s, s32 = _jax_ve_step(BENCH_FLAGS), _jax_ve_step(F32_FLAGS)
  noise = tcel.replay_step_noise(s["fm"], s["f_params"], s["f_buffers"],
                                 s["ss"].rng)
  losses = torch_joint.make_joint_losses(s["tc"], torch_sde.get_sde(s["tc"]),
                                         s["score"], s["flow"])
  calls = []
  with pytest.MonkeyPatch.context() as mp:
    for mod, name in ((pfb, "fused_block_fwd_plain"),
                      (pfs, "fused_stack_fwd_plain"),
                      (neumann, "neumann_chain_plain"),
                      (fir, "upfirdn2d_plain")):
      fn = getattr(mod, name)

      def spy(*a, _fn=fn, _name=name, **kw):
        calls.append((_name, a[0].shape[1], a[0].dtype,
                      a[-1] if _name.startswith("fused") else None))
        return _fn(*a, **kw)

      mp.setattr(mod, name, spy)
    mp.setattr(torch_ncsnpp, "torch", tcel._XlaLog())
    aux = losses(_nchw(s["batch"]), noise)
    aux["losses"].mean().backward()
  return s, s32, aux, calls


def test_ve_step_under_the_flags_takes_each_route(ve_step):
  """The port's step took the fused pair (the first block) and one stack
  (scale 0's other two blocks) in bfloat16 at 12 channels, kernel 7 in
  bfloat16 at 48 channels for scale 1's two blocks, and the FIR in
  float32 on bfloat16 values and on the float32 pyramid."""
  _, _, _, calls = ve_step
  pair = ("fused_block_fwd_plain", 12, torch.float32, BF16)
  fused = [c for c in calls if c[0].startswith("fused")]
  # the stack's plain version runs the pair's for each of its blocks
  assert fused == [pair, ("fused_stack_fwd_plain", 12, torch.float32, BF16),
                   pair, pair]
  chains = [c[1:3] for c in calls if c[0] == "neumann_chain_plain"]
  assert chains == [(48, BF16)] * 2
  # two in the down block, two in the up block, one in the pyramid
  firs = [c[1:3] for c in calls if c[0] == "upfirdn2d_plain"]
  assert len(firs) == 5 and {d for _, d in firs} == {torch.float32}


def test_ve_step_under_the_flags_losses_match(ve_step):
  """Per-example losses against `step_nll` under the same flags: every
  term within 2e-2 of its scale, losses = score + flow + logp; the flow
  and prior terms (the bfloat16 kernels' log-dets) also nearer JAX's
  bfloat16 step than half of its gap to the float32 one
  (`test_torch_bf16.test_bench_step_losses_match`)."""
  s, s32, aux, _ = ve_step
  for name, want, want32 in zip(torch_joint.METRICS, s["metrics"],
                                s32["metrics"]):
    got = aux[name].detach().numpy()
    assert np.isfinite(got).all(), name
    err = np.abs(got - want).max()
    assert err <= BOUND * np.abs(want).max(), name
    if name in ("losses_flow", "losses_logp"):
      assert err < 0.5 * np.abs(want32 - want).max(), name
  np.testing.assert_allclose(
      aux["losses"].detach().numpy(),
      (aux["losses_score"] + aux["losses_flow"]
       + aux["losses_logp"]).detach().numpy(), rtol=1e-5)


@pytest.mark.parametrize("net", ["score", "flow"])
def test_ve_step_under_the_flags_gradients_match(ve_step, net):
  """Each net's gradients before any update against JAX's bfloat16 step:
  the largest error at most twice the largest difference between JAX's
  float32 and bfloat16 steps (`test_torch_bf16`'s step bound)."""
  s, s32, _, _ = ve_step
  model = s[net]
  named = dict(model.named_parameters())
  assert set(named) <= set(s["grads"]) and len(named) > 20
  err = gap = 0.0
  for name, p in named.items():
    assert p.grad is not None and torch.isfinite(p.grad).all(), name
    want = s["grads"][name]
    err = max(err, (p.grad - want).abs().max().item())
    gap = max(gap, (s32["grads"][name] - want).abs().max().item())
  assert gap > 0 and err <= 2 * gap, (err, gap)
