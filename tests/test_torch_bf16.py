"""The bfloat16 mode of the port against the JAX package: kernels 3-6 (the
fused pair and the fused stack, plain versions), the VP score net under
`model.mixed_precision`, the plain Lipschitz net and `bwdpass` under
`flow.mixed_precision`, `model.fast_dropout`, and the tiny joint step
under the flags of the JAX package's benchmark (`bench.py:56-80`).

Kernels 3-6 run as the fused tests run them (`test_torch_fused_block.py`,
`test_torch_fused_stack.py`: width 64, 8x8, batch 4 for the pair and 32
for a stack of 3), with cfg (offset 2, preact, "bfloat16", interpret). XLA's
CPU compiler may keep a bfloat16 intermediate in float32 ("excess
precision"), so the JAX side whose roundings the port follows one by one
is compiled with `xla_allow_excess_precision` off: then every `.astype`
of the kernel body rounds, as it does in Mosaic on the TPU. Each check
computes the JAX float32 result on the same inputs too and asserts two
things of every output: the port is closer to JAX's bfloat16 than half of
|JAX float32 - JAX bfloat16|, so the test tells the modes apart; and it is
within 2e-2 of the output's scale of JAX's bfloat16, the JAX package's own
bfloat16 bound (`tests/test_models.py:43-61`).

The score net, the Lipschitz net and the joint step are held at 2e-2 of
the scale, the same bound. The master weights stay float32, so the
weights cross over through `indm_torch.convert` as in float32: no new
converter.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_fused_block as tfb
import test_torch_fused_stack as tfs
import test_torch_train_step as tts
from indm_torch import configs as torch_configs
from indm_torch import convert
from indm_torch.flows import flow_model as torch_fm
from indm_torch.models import layers as torch_layers
from indm_torch.models.ncsnpp import NCSNpp
from indm_torch.ops import fused_block as pfb
from indm_torch.ops import fused_stack as pfs
from indm_tpu import configs as jax_configs
from indm_tpu.flows import flow_model as jax_fm
from indm_tpu.models import create_model as jax_create_model
from indm_tpu.ops import fused_block as jfb
from indm_tpu.ops import fused_stack as jfs
from test_torch_neumann import _nchw, _nhwc
from torch_threads import one_torch_thread  # noqa: F401

BF16 = torch.bfloat16
BOUND = 2e-2   # of the output's scale: `tests/test_models.py:61`
STRICT = {"xla_allow_excess_precision": False}


def _strict(fn):
  return jax.jit(fn, compiler_options=STRICT)


def _double(args):
  """The plain versions' arguments in float64: chip_smoke.py and the card
  tests hold the bfloat16 kernels against the plain versions run so (every
  rounding point kept, every other sum exact)."""
  return [a.double() if torch.is_tensor(a) else a for a in args]


def _close(name, port, j16, j32):
  """The port against JAX's bfloat16 (strict) and JAX's float32: closer
  to the first than half of its gap to the second, and within BOUND of the
  output's scale of the first."""
  port, j16, j32 = (np.asarray(a, np.float64) for a in (port, j16, j32))
  gap = np.abs(j32 - j16).max()
  err = np.abs(port - j16).max()
  assert gap > 0, name
  assert err < 0.5 * gap, (name, err, gap)
  assert err <= BOUND * np.abs(j32).max(), (name, err)


# ---- kernels 3 and 4 ----

def _block_apply(dtype_name, preact, n, eps, strict):
  def fn(x, ws, bs, hp):
    return jfb.fused_block_apply((tfb.OFFSET, preact, dtype_name, True), x,
                                 *ws, *bs, hp, jnp.asarray(eps),
                                 jnp.asarray(n, jnp.int32),
                                 jnp.asarray(tfb.TABLE))
  return _strict(fn) if strict else fn


def _jax_block(x, ws, bs, hp):
  return (jnp.asarray(x), tuple(map(jnp.asarray, ws)),
          tuple(map(jnp.asarray, bs)), None if hp is None else jnp.asarray(hp))


@pytest.mark.parametrize("c", [3, 12])
@pytest.mark.parametrize("preact,cond", tfb.CASES)
def test_block_forward_bf16_matches_jax(preact, cond, c):
  """(y, logdet) of `fused_block_fwd` in bfloat16 (the plain version on
  the CPU), and of the plain version in float64, against
  `fused_block_apply` with "bfloat16" and "float32"."""
  n = 3
  x, ws, bs, hp, eps = tfb._inputs(c, cond)
  port_args = (*tfb._port_args(x, ws, bs, hp, eps), n, tfb.OFFSET,
               tfb.TABLE, preact)
  pfb.reset_launches()
  y, ld, _ = pfb.fused_block_fwd(*port_args, BF16)
  assert pfb.fwd_launches == 0
  y64, ld64, _ = pfb.fused_block_fwd_plain(*_double(port_args), BF16)
  args = _jax_block(x, ws, bs, hp)
  j16 = _block_apply("bfloat16", preact, n, eps, True)(*args)
  j32 = _block_apply("float32", preact, n, eps, False)(*args)
  _close("y", _nhwc(y), j16[0], j32[0])
  _close("logdet", ld.numpy(), j16[1], j32[1])
  _close("y float64", _nhwc(y64), j16[0], j32[0])
  _close("logdet float64", ld64.numpy(), j16[1], j32[1])


@pytest.mark.parametrize("c", [3, 12])
@pytest.mark.parametrize("preact,cond", tfb.CASES)
def test_block_backward_bf16_matches_jax_grad(preact, cond, c):
  """The eight gradients of `fused_block_bwd` in bfloat16 for
  0.1 * sum(y cos y) + 0.7 * sum(logdet), and of the plain version in
  float64 on the same cotangents, against `jax.grad` of the bfloat16 and
  float32 applies."""
  n = 2
  x, ws, bs, hp, eps = tfb._inputs(c, cond, seed=1)
  args = tfb._port_args(x, ws, bs, hp, eps)
  xt, w0, w1, w2, b0, b1, _, hpt, et = args
  y, _, u = pfb.fused_block_fwd(*args, n, tfb.OFFSET, tfb.TABLE, preact,
                                BF16)
  ybar, lbar = tfb._loss_cotangents(y)
  bargs = (xt, et, u, ybar, lbar, w0, w1, w2, b0, b1, hpt, preact)
  got = pfb.fused_block_bwd(*bargs, BF16)
  got64 = pfb.fused_block_bwd_plain(*_double(bargs), BF16)

  def grads(dtype_name, strict):
    apply = _block_apply(dtype_name, preact, n, eps, False)

    def loss(xx, wws, bbs, hh):
      yy, ld = apply(xx, wws, bbs, hh)
      return jnp.sum(yy * jnp.cos(yy)) * 0.1 + jnp.sum(ld * 0.7)

    g = jax.grad(loss, argnums=(0, 1, 2, 3))
    gx, gw, gb, gh = (_strict(g) if strict else g)(*_jax_block(x, ws, bs, hp))
    out = ([np.asarray(gx).transpose(0, 3, 1, 2)]
           + [np.asarray(a).transpose(3, 2, 0, 1) for a in gw]
           + [np.asarray(a) for a in gb])
    return out + ([] if hp is None else [np.asarray(gh)])

  names = ["xbar", "w0g", "w1g", "w2g", "b0g", "b1g", "b2g", "hbar"]
  for name, a, a64, b16, b32 in zip(names, got, got64,
                                    grads("bfloat16", True),
                                    grads("float32", False)):
    _close(name, a.numpy(), b16, b32)
    _close(f"{name} float64", a64.numpy(), b16, b32)


# ---- kernels 5 and 6 ----

def _stack_apply(dtype_name, eps, n_all, strict):
  def fn(x, ws, bs, hp):
    return jfs.fused_stack_apply((tfs.OFFSET, True, dtype_name, True), x,
                                 *ws, *bs, hp, jnp.asarray(eps),
                                 jnp.asarray(n_all), jnp.asarray(tfs.TABLE))
  return _strict(fn) if strict else fn


@pytest.mark.parametrize("c,cond", [(3, True), (12, False)])
def test_stack_bf16_matches_jax(c, cond):
  """`fused_stack_fwd` and `fused_stack_bwd` in bfloat16 (plain versions)
  for 0.1 * sum(y cos y) + 0.7 * sum(ld_sum), and the plain versions in
  float64 on the same cotangents, against `fused_stack_apply` with
  "bfloat16" and "float32": y, the summed log-det and the eight stacked
  gradients."""
  x, ws, bs, hp, eps, n_all = tfs._inputs(c, cond)
  args = tfs._port_args(x, ws, bs, hp, eps, n_all)
  pfs.reset_launches()
  y, ld_all, u_all, xs_all = pfs.fused_stack_fwd(*args, BF16)
  ybar, lbar = 0.1 * (torch.cos(y) - y * torch.sin(y)), torch.full(
      (tfs.B,), 0.7)
  _, w0s, w1s, w2s, b0s, b1s, _, hps, veps, *_ = args
  bargs = (xs_all, veps, u_all, ybar, lbar, w0s, w1s, w2s, b0s, b1s, hps,
           True)
  got = pfs.fused_stack_bwd(*bargs, BF16)
  assert (pfs.fwd_launches, pfs.bwd_launches) == (0, 0)
  y64, ld64, u64, xs64 = pfs.fused_stack_fwd_plain(*_double(args), BF16)
  got64 = pfs.fused_stack_bwd_plain(
      *_double((xs64, veps, u64) + bargs[3:]), BF16)
  jargs = (jnp.asarray(x), tuple(map(jnp.asarray, ws)),
           tuple(map(jnp.asarray, bs)),
           None if hp is None else jnp.asarray(hp))

  def run(dtype_name, strict):
    apply = _stack_apply(dtype_name, eps, n_all, False)

    def loss(xx, wws, bbs, hh):
      yy, ld = apply(xx, wws, bbs, hh)
      return jnp.sum(yy * jnp.cos(yy)) * 0.1 + jnp.sum(ld * 0.7), (yy, ld)

    g = jax.grad(loss, argnums=(0, 1, 2, 3), has_aux=True)
    (gx, gw, gb, gh), (yy, ld) = (_strict(g) if strict else g)(*jargs)
    out = [np.asarray(yy), np.asarray(ld),
           np.asarray(gx).transpose(0, 3, 1, 2)]
    out += [np.asarray(a).transpose(0, 4, 3, 1, 2) for a in gw]
    out += [np.asarray(a) for a in gb]
    return out + ([] if hp is None else [np.asarray(gh)])

  port, port64 = ([_nhwc(yy), ld.sum(0).numpy()]
                   + [a.numpy() for a in gg if a is not None]
                   for yy, ld, gg in ((y, ld_all, got), (y64, ld64, got64)))
  names = ["y", "ld_sum", "xbar", "w0g", "w1g", "w2g", "b0g", "b1g", "b2g",
           "hbar"]
  for name, a, a64, b16, b32 in zip(names, port, port64,
                                    run("bfloat16", True),
                                    run("float32", False)):
    _close(name, a, b16, b32)
    _close(f"{name} float64", a64, b16, b32)


def test_wrappers_refuse_what_the_bf16_kernels_do_not_take():
  """bfloat16 rows are 16-byte copies of 8 values: a width or H*W that is
  a multiple of 4 but not of 8 is refused in bfloat16 (and taken in
  float32), on the CPU as on the card; so is a type other than the two."""
  c, idim, b = 3, 36, 2
  rng = np.random.default_rng(0)
  x = torch.from_numpy(rng.normal(size=(b, c, 4, 4)).astype(np.float32))
  ws = [torch.zeros(idim, c, 3, 3), torch.zeros(idim, idim, 1, 1),
        torch.zeros(c, idim, 3, 3)]
  bs = [torch.zeros(idim), torch.zeros(idim)]
  pfb._check(x, *ws, *bs, None)
  with pytest.raises(ValueError, match="multiple of 8"):
    pfb._check(x, *ws, *bs, None, compute_dtype=BF16)
  with pytest.raises(ValueError, match="float32 or bfloat16"):
    pfb._check(x, *ws, *bs, None, compute_dtype=torch.float16)


def test_bf16_scratch_sizes_match_the_sources():
  """Kernels 3-6's scratch bytes in bfloat16 (the wrappers') against the
  formulas in `csrc/fused_block_ops.cuh`'s comments; kernels 5 and 6 add
  the transposed convs in bfloat16 and kernel 6 the float32 carry."""
  header = (Path(pfb.__file__).resolve().parents[1] / "csrc"
            / "fused_block_ops.cuh").read_text()
  text = " ".join(line.strip().lstrip("/").strip()
                  for line in header.splitlines())
  fwd = re.search(r"in bfloat16, (8\*B\*I\*H\*W .*?) bytes", text).group(1)
  bwd = re.search(r"in bfloat16, (28\*B\*I\*H\*W .*?) bytes", text).group(1)
  for b, c, hw, idim, nb in [(128, 3, 32, 512, 15), (128, 12, 16, 512, 16),
                             (4, 3, 8, 64, 3)]:
    names = dict(B=b, C=c, H=hw, W=hw, I=idim)
    assert eval(fwd, {}, names) == pfb.fwd_scratch_bytes(b, c, hw * hw, idim,
                                                         BF16)
    assert eval(bwd, {}, names) == pfb.bwd_scratch_bytes(b, c, hw * hw, idim,
                                                         BF16)
    wt = 2 * nb * (18 * idim * c + idim * idim)
    assert pfs.fwd_scratch_bytes(nb, b, c, hw * hw, idim, BF16) == (
        wt + eval(fwd, {}, names))
    assert pfs.bwd_scratch_bytes(nb, b, c, hw * hw, idim, BF16) == (
        wt + 4 * b * c * hw * hw + eval(bwd, {}, names))


# ---- the score net under model.mixed_precision ----

SCORE_TINY = {"data.image_size": 16, "model.nf": 16,
              "model.num_res_blocks": 1, "model.ch_mult": (1, 2),
              "model.attn_resolutions": (8,), "model.init_scale": 1.0}


def _configs(overrides):
  jc = jax_configs.get_config("vp/CIFAR10/indm_nll")
  tc = torch_configs.get_config("vp/CIFAR10/indm_nll")
  for k, v in overrides.items():
    tts._set(jc, k, v)
    tts._set(tc, k, v)
  return jc, tc


@pytest.mark.parametrize("fused", [False, True])
def test_score_net_mixed_precision_matches_jax(fused):
  """The VP net under `model.mixed_precision` (GroupNorm through the
  kernel's plain version with `fused`) against the JAX net under the same
  flag, at 2e-2 of the output's scale; it returns float32 and is not the
  float32 net."""
  jc, tc = _configs({**SCORE_TINY, "model.mixed_precision": True,
                     "model.fused_groupnorm": fused})
  module, variables = jax_create_model(jc, jax.random.PRNGKey(0))
  net = NCSNpp(tc).eval()
  net.load_state_dict(convert.score_state_dict_from_jax(
      tts._np(variables["params"]), tc), strict=True)
  x = np.random.default_rng(0).normal(size=(2, 16, 16, 3)).astype(np.float32)
  t = np.asarray([0.1, 0.9], np.float32) * 999
  want = np.asarray(module.apply(variables, jnp.asarray(x), jnp.asarray(t),
                                 train=False))
  with torch.no_grad():
    got = net(_nchw(x), torch.from_numpy(t))
    net32 = NCSNpp(_configs({**SCORE_TINY,
                             "model.fused_groupnorm": fused})[1]).eval()
    net32.load_state_dict(net.state_dict())
    f32 = net32(_nchw(x), torch.from_numpy(t))
  assert got.dtype == torch.float32
  scale = np.abs(want).max()
  assert np.abs(_nhwc(got) - want).max() <= BOUND * scale
  assert np.abs(_nhwc(got) - _nhwc(f32)).max() > 1e-4 * scale


def _block_cases():
  """(name, flax module, port module, in channels) of the score net's
  blocks under `model.mixed_precision`."""
  from indm_tpu.models import layers as jl
  bf = torch.bfloat16
  cases = []
  for name, out_ch, kw in (("same", 16, {}), ("wider", 24, {}),
                           ("down", 16, {"down": True}),
                           ("up", 16, {"up": True})):
    cases.append((f"resblock_{name}", jl.ResnetBlockBigGANpp(
        act=jax.nn.silu, out_ch=out_ch, dropout=0.1, init_scale=1.0, **kw),
        torch_layers.ResnetBlockBigGANpp(16, out_ch, temb_dim=32,
                                         init_scale=1.0, compute_dtype=bf,
                                         **kw).eval()))
  cases.append(("attention", jl.AttnBlockpp(skip_rescale=True,
                                            init_scale=1.0),
                torch_layers.AttnBlockpp(16, skip_rescale=True,
                                         init_scale=1.0, compute_dtype=bf)))
  return cases


@pytest.mark.parametrize("case", range(5))
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_score_blocks_mixed_precision_match_flax(case, x_dtype):
  """Each block of the VP net under `model.mixed_precision` (the BigGAN
  res block plain, widening, down and up, and the attention block), with
  weights moved to 0.2 from their init, against the flax block in the
  same compute scope, with the tolerance of the kernels' checks: closer to
  the flax block in bfloat16 than half of its gap to the flax block in
  float32, and within 2e-2 of the scale. The rounding points are the
  same, so the two differ only where a float32 sum taken in another order
  (the GroupNorm statistics) rounds to the other side. The net's own
  check above is looser because the tiny net amplifies one rounding apart
  to about the float32-bfloat16 gap: JAX's own eager and jitted bfloat16
  nets differ by as much."""
  from indm_tpu.models import layers as jl
  name, jmod, tmod = _block_cases()[case]
  rng = np.random.default_rng(case)
  x = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
  temb = rng.normal(size=(2, 32)).astype(np.float32)
  xj = jnp.asarray(x).astype(jnp.dtype(x_dtype))
  inputs, kw = ((xj,), {}) if name == "attention" else (
      (xj, jnp.asarray(temb)), {"train": False})
  with jl.compute_dtype_scope(jnp.bfloat16):
    params = jmod.init(jax.random.PRNGKey(case), *inputs, **kw)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.2 * jnp.asarray(rng.normal(size=a.shape), a.dtype),
        params)
    want = _strict(lambda p, *a: jmod.apply(p, *a, **kw))(params, *inputs)
  want32 = jmod.apply(params, *inputs, **kw)
  tmod.load_state_dict(convert._score_module(
      tmod, tts._np(params["params"])), strict=True)
  xt = _nchw(x).to(getattr(torch, x_dtype))
  with torch.no_grad():
    got = tmod(xt) if name == "attention" else tmod(xt,
                                                    torch.from_numpy(temb))
  assert got.dtype == torch.float32, name
  _close(name, _nhwc(got), want, want32)


# ---- the Lipschitz net and bwdpass under flow.mixed_precision ----

@pytest.fixture(scope="module")
def mp_flows():
  jc, tc = _configs({"data.image_size": 8, "flow.nblocks": "2-2",
                     "flow.intermediate_dim": 8,
                     "flow.mixed_precision": True})
  fm = jax_fm.create_flow_model(jc)
  params, _ = fm.init(jax.random.PRNGKey(1))
  model = torch_fm.FlowModel(tc)
  model.load_state_dict(convert.flow_state_dict_from_jax(
      tts._np(params), tc), strict=True)
  return fm, params, model.eval()


def test_lipschitz_net_mixed_precision_matches_jax(mp_flows):
  """g of a block without and a block with the pre-activation under
  `flow.mixed_precision` against `LipschitzNNet.apply` in bfloat16: float32
  out, within 2e-2 of the scale, and not the float32 net."""
  fm, params, model = mp_flows
  rng = np.random.default_rng(1)
  x = rng.normal(size=(4, 8, 8, 3)).astype(np.float32)
  h = rng.normal(size=(4, 64)).astype(np.float32)
  for b in (0, 1):
    j_block = fm.resflow.transforms[0].layers[b]
    assert j_block.nnet.mixed_precision
    want = np.asarray(j_block.nnet.apply(params["resflow"][0][b]["nnet"],
                                         jnp.asarray(x), h=jnp.asarray(h)))
    block = model.resflow.transforms[0].chain[b]
    with torch.no_grad():
      got = block.g(_nchw(x), torch.from_numpy(h))
      block.mixed_precision = False
      f32 = block.g(_nchw(x), torch.from_numpy(h))
      block.mixed_precision = True
    assert got.dtype == torch.float32
    scale = np.abs(want).max()
    assert np.abs(_nhwc(got) - want).max() <= BOUND * scale
    assert np.abs(_nhwc(got - f32)).max() > 1e-4 * scale


def test_bwdpass_mixed_precision_matches_jax(mp_flows):
  """The multi-scale fixed-point inverse under `flow.mixed_precision`
  against the JAX `bwdpass`, within 2e-2 of the scale."""
  fm, params, model = mp_flows
  rng = np.random.default_rng(3)
  z = rng.normal(size=(4, 8, 8, 3)).astype(np.float32)
  h = rng.normal(size=(4, 64)).astype(np.float32)
  want, _ = fm.resflow.bwdpass(params["resflow"], jnp.asarray(z),
                               h=jnp.asarray(h))
  got, _ = model.resflow.bwdpass(_nchw(z), torch.from_numpy(h))
  want = np.asarray(want)
  assert np.abs(_nhwc(got) - want).max() <= BOUND * np.abs(want).max()


# ---- model.fast_dropout ----

def test_fast_dropout_keeps_one_minus_rate():
  """Under `model.fast_dropout` the kept share of a million draws is
  1 - rate within five binomial standard deviations, the kept values are
  x times 1 / (1 - rate) in x's type, and the rest are 0."""
  rate, n = 0.1, 1_000_000
  for dtype in (torch.float32, BF16):
    x = torch.full((n,), 1.5, dtype=dtype)
    y = torch_layers.dropout(x, rate, torch.Generator().manual_seed(0),
                             fast=True)
    kept = (y != 0).double().mean().item()
    assert abs(kept - (1 - rate)) < 5 * np.sqrt(rate * (1 - rate) / n)
    scale = torch.tensor(1 / (1 - rate), dtype=dtype)
    assert torch.equal(y[y != 0], (x * scale)[y != 0])


def test_fast_dropout_off_changes_no_bit():
  """With dropout off (rate 0, or eval) `model.fast_dropout` changes no
  bit of the VP net's output, in train mode as in eval."""
  x = torch.from_numpy(np.random.default_rng(2).normal(
      size=(2, 3, 16, 16)).astype(np.float32))
  t = torch.tensor([100.0, 800.0])
  outs = {}
  for fast in (False, True):
    _, tc = _configs({**SCORE_TINY, "model.fast_dropout": fast,
                      "model.dropout": 0.0})
    net = NCSNpp(tc, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
      outs[fast] = (net.train()(x, t, torch.Generator().manual_seed(1)),
                    net.eval()(x, t))
  for a, b in zip(outs[False], outs[True]):
    assert torch.equal(a, b)


# ---- the tiny joint step under the benchmark's flags ----

BENCH_FLAGS = {"flow.fused_block": True, "flow.logdet_bf16": True,
               "flow.mixed_precision": True, "model.mixed_precision": True,
               "model.fast_dropout": True, "model.fused_groupnorm": False,
               "flow.intermediate_dim": 64}


@pytest.fixture(scope="module")
def bench_setup():
  """The JAX step at the tiny geometry of `test_torch_train_step.py`
  (dropout 0, so no mask is drawn) under the benchmark's flags, width 64
  so that every block takes the fused kernels, compiled strictly; and the
  same step with the three precision switches off (float32), whose
  distance to it is the scale of what bfloat16 changes."""
  f32 = {**BENCH_FLAGS, "flow.logdet_bf16": False,
         "flow.mixed_precision": False, "model.mixed_precision": False}
  gen32 = tts.jax_step_setup(f32, compiler_options=STRICT)
  s32 = next(gen32)
  gen = tts.jax_step_setup(BENCH_FLAGS, compiler_options=STRICT)
  s = next(gen)
  s["f32"] = s32
  yield s
  next(gen, None)
  next(gen32, None)


@pytest.fixture(scope="module")
def bench_port_step(bench_setup):
  calls = {}
  with pytest.MonkeyPatch.context() as mp:
    for mod, name in ((pfb, "fused_block_fwd_plain"),
                      (pfs, "fused_stack_fwd_plain")):
      fn = getattr(mod, name)

      def spy(*a, _fn=fn, _name=name):
        calls.setdefault(_name, []).append(a[-1])
        return _fn(*a)

      mp.setattr(mod, name, spy)
    out = tts.run_port_step(bench_setup)
  return out, calls


def test_bench_step_took_the_bf16_kernels(bench_port_step):
  """The port's step ran the first blocks through kernel 3's and scale
  1's stack through kernel 5's plain version, all in bfloat16."""
  _, calls = bench_port_step
  assert calls["fused_block_fwd_plain"]
  assert calls["fused_stack_fwd_plain"] == [BF16]
  assert set(calls["fused_block_fwd_plain"]) == {BF16}


def test_bench_step_losses_match(bench_setup, bench_port_step):
  """Per-example losses against `step_nll` under the same flags: every
  term within 2e-2 of its scale, losses = score + flow + logp; the flow
  and prior terms (the bfloat16 kernels' log-dets) also closer to JAX's
  bfloat16 step than half of its gap to the float32 one."""
  (_, _, aux), _ = bench_port_step
  for name, want, want32 in zip(tts.torch_joint.METRICS,
                                bench_setup["metrics"],
                                bench_setup["f32"]["metrics"]):
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


def test_bench_step_gradients_match(bench_setup, bench_port_step):
  """Both nets' gradients before any update against JAX's bfloat16 step:
  per net, the largest error is at most twice the largest difference
  between JAX's own float32 and bfloat16 steps (both relative to the
  net's largest gradient; 3.7e-2 and 2.9e-2 for the score net and the
  flow on this input): one rounding apart, the bfloat16 score net drifts
  by about as much as bfloat16 changes (see the blocks' test)."""
  (score, flow, _), _ = bench_port_step
  pairs = list(tts._grad_pairs(bench_setup, (score, flow, None)))
  want32 = {n: w for n, _, w in tts._grad_pairs(bench_setup["f32"],
                                                (score, flow, None))}
  assert len(pairs) > 100
  flow_names = dict(flow.named_parameters())
  err, gap, top = ({"score": 0.0, "flow": 0.0} for _ in range(3))
  for name, p, want in pairs:
    net = "flow" if name in flow_names else "score"
    assert torch.isfinite(p.grad).all(), name
    err[net] = max(err[net], (p.grad - want).abs().max().item())
    gap[net] = max(gap[net], (want32[name] - want).abs().max().item())
    top[net] = max(top[net], want.abs().max().item())
  for net in err:
    assert gap[net] > 0, net
    assert err[net] <= 2 * gap[net], (net, err[net] / top[net],
                                      gap[net] / top[net])
