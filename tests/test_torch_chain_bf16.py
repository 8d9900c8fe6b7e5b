"""The chain route's bfloat16 mode against the JAX package: kernels 7 and 8
in bfloat16 (plain versions), `IResBlock.chain_mats` and the block's
training forward under `flow.logdet_bf16` and `flow.mixed_precision`, the
tiny joint step under the chain-route flags of the JAX package's
benchmark (`bench.py:56-67` with BENCH_FUSED_BLOCK=0), with and without
INDM_FUSED_CHAIN=1; and `flow.logdet_unroll` on every kernel route.

The JAX side runs the Pallas kernels in interpret mode and is compiled
with `xla_allow_excess_precision` off (`test_torch_bf16.STRICT`), so that
every `.astype` of the kernel bodies rounds. The tolerance is
`test_torch_bf16._close`: the port nearer JAX's bfloat16 result than half
of JAX's float32-to-bfloat16 gap, and within 2e-2 of the output's scale.
The plain versions also run on float64 inputs with
`compute_dtype=torch.bfloat16` (every rounding point kept, every other sum
exact), the card's reference in `chip_smoke.py`.
"""

import copy
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_fused_chain as tfc
import test_torch_neumann as tn
import test_torch_train_step as tts
from indm_torch import convert
from indm_torch.flows import resflow as torch_resflow
from indm_torch.ops import fused_block as pfb
from indm_torch.ops import neumann
from indm_tpu.flows.resflow import IResBlock, LipschitzNNet
from indm_tpu.ops import neumann_pallas
from test_torch_bf16 import BOUND, STRICT, _close, _strict
from test_torch_neumann import _nchw, _nhwc
from torch_threads import one_torch_thread  # noqa: F401

BF16 = torch.bfloat16
OFFSET = tn.OFFSET
TABLE = tfc.TABLE


def _t(a, dtype=torch.float32, layout=None):
  """A JAX array as a torch tensor of `dtype`: NHWC -> NCHW ("nchw") or
  HWIO -> OIHW ("oihw")."""
  a = np.asarray(jnp.asarray(a).astype(jnp.float32))
  if layout == "nchw":
    a = a.transpose(0, 3, 1, 2)
  elif layout == "oihw":
    a = a.transpose(3, 2, 0, 1)
  return torch.from_numpy(np.array(a)).to(dtype)


def _step(want):
  """The spacing of bfloat16 values at each element of want's binade."""
  want = np.asarray(want, np.float64)
  return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                 - 7)


def _ulps(got, want):
  """|got - want| in bfloat16 steps of want."""
  return np.abs(np.asarray(got, np.float64) - want) / _step(want)


# ---- kernel 7 ----

@pytest.mark.parametrize("n", [0, 2])
@pytest.mark.parametrize("preact,cond", tn.CASES)
@pytest.mark.parametrize("c", [3, 12])
def test_chain_plain_bf16_matches_pallas_and_ref(c, preact, cond, n):
  """`neumann_chain` on bfloat16 inputs (the plain version on the CPU),
  and the plain version in float64, against `neumann_chain_pallas`
  (interpret) and `neumann_chain_ref` on the JAX net's bfloat16
  `chain_mats`; the float32 chain on its float32 `chain_mats` is the
  gap."""
  nnet, params, _, x, h, eps = tn._setup(preact, cond, in_ch=c)
  hj = None if h is None else jnp.asarray(h)
  wt16, d16 = nnet.chain_mats(params, jnp.asarray(x), h=hj,
                              dtype=jnp.bfloat16)
  wt32, d32 = nnet.chain_mats(params, jnp.asarray(x), h=hj)
  e16 = jnp.asarray(eps).astype(jnp.bfloat16)
  nj, table = jnp.asarray(n, jnp.int32), jnp.asarray(TABLE)
  j16 = _strict(lambda e, d, w: neumann_pallas.neumann_chain_pallas(
      e, d, w, nj, OFFSET, table, preact=preact, interpret=True))(
          e16, d16, wt16)
  r16 = _strict(lambda e, d, w: neumann_pallas.neumann_chain_ref(
      e, d, w, nj, OFFSET, table))(e16, d16, wt16)
  j32 = neumann_pallas.neumann_chain_ref(jnp.asarray(eps), d32, wt32, nj,
                                         OFFSET, table)
  args = ([_t(e16, BF16, "nchw")], [_t(d, BF16, "nchw") for d in d16],
          [_t(w, BF16, "oihw") for w in wt16])
  neumann.reset_launches()
  acc = neumann.neumann_chain(*args[0], args[1], args[2], n, OFFSET, TABLE)
  assert (neumann.launches, neumann.bf16_launches) == (0, 0)
  assert acc.dtype == torch.float32
  acc64 = neumann.neumann_chain_plain(
      args[0][0].double(), [d.double() for d in args[1]],
      [w.double() for w in args[2]], n, OFFSET, TABLE, BF16)
  _close("acc pallas", _nhwc(acc), j16, j32)
  _close("acc ref", _nhwc(acc), r16, j32)
  _close("acc float64", _nhwc(acc64), j16, j32)


@pytest.mark.parametrize("preact,cond", tn.CASES)
@pytest.mark.parametrize("c", [3, 12])
def test_chain_mats_bf16_matches_jax(c, preact, cond):
  """`IResBlock.chain_mats(dtype=bfloat16)` against
  `LipschitzNNet.chain_mats(dtype=bfloat16)`: the transposed weights
  bit-equal after the cast, every diagonal bfloat16 and within one
  bfloat16 step of JAX's."""
  nnet, params, block, x, h, _ = tn._setup(preact, cond, in_ch=c)
  hj = None if h is None else jnp.asarray(h)
  wt16, d16 = nnet.chain_mats(params, jnp.asarray(x), h=hj,
                              dtype=jnp.bfloat16)
  with torch.no_grad():
    wt, d = block.chain_mats(_nchw(x),
                             None if h is None else torch.from_numpy(h), BF16)
  assert len(d) == len(d16) == (3 if preact else 2)
  for a, b in zip(wt, wt16):
    assert a.dtype == BF16
    np.testing.assert_array_equal(a.float().numpy(),
                                  _t(b, layout="oihw").numpy())
  for a, b in zip(d, d16):
    assert a.dtype == BF16
    assert _ulps(_nhwc(a.float()), np.asarray(b.astype(jnp.float32))).max() \
        <= 1.0


# ---- kernel 8 ----

@pytest.mark.parametrize("preact,cond", tfc.CASES)
def test_fused_chain_plain_bf16_matches_pallas(preact, cond):
  """`fused_chain_inputs(dtype=bfloat16)` against the JAX packing in
  bfloat16 (the weights bit-equal, hp within one bfloat16 step), then
  `fused_neumann_chain` on them (the plain version) against
  `fused_neumann_chain_pallas` (interpret) in bfloat16; the float32 kernel
  is the gap. (The plain version in float64 is not held to JAX here: at
  this size one bfloat16 rounding of z1 or z2 that an exact sum takes to
  the other side moves acc by most of the small gap.)"""
  n = 2
  nnet, params, block, x, h, eps = tfc._setup(preact, cond)
  hj = None if h is None else jnp.asarray(h)

  def pallas(dtype):
    fwd, biases, mats, hp = neumann_pallas.fused_chain_inputs(
        nnet.convs, params, hj, dtype)
    cast = (lambda a: a.astype(dtype)) if dtype else (lambda a: a)
    fn = lambda *a: neumann_pallas.fused_neumann_chain_pallas(
        *a, fwd, biases, mats, hp, jnp.asarray(n, jnp.int32), OFFSET,
        jnp.asarray(TABLE), preact=preact, interpret=True)
    out = (_strict(fn) if dtype else fn)(cast(jnp.asarray(x)),
                                         cast(jnp.asarray(eps)))
    return out, (fwd, biases, mats, hp)

  j16, (fwd_j, biases_j, mats_j, hp_j) = pallas(jnp.bfloat16)
  j32, _ = pallas(None)
  with torch.no_grad():
    (w0, w1), biases, weights_t, hp = neumann.fused_chain_inputs(
        block, None if h is None else torch.from_numpy(h), BF16)
  ci = x.shape[-1]
  packed = [w0.permute(2, 3, 1, 0).reshape(9 * ci, -1), w1.T,
            weights_t[0].permute(2, 3, 1, 0).reshape(9 * ci, -1),
            weights_t[1][:, :, 0, 0].T,
            weights_t[2].permute(1, 2, 3, 0).reshape(-1, 9 * ci)]
  for a, b in zip(packed + list(biases), [*fwd_j, *mats_j, *biases_j]):
    assert a.dtype == BF16
    np.testing.assert_array_equal(a.float().numpy(), _t(b).numpy())
  assert (hp is None) == (hp_j is None) == (not cond)
  if cond:
    assert hp.dtype == BF16
    assert _ulps(hp.float().numpy(), _t(hp_j).numpy()).max() <= 1.0
  args = (_nchw(x).to(BF16), _nchw(eps).to(BF16), (w0, w1), biases,
          weights_t, hp, n, OFFSET, TABLE, preact)
  neumann.reset_launches()
  acc = neumann.fused_neumann_chain(*args)
  assert (neumann.fused_launches, neumann.fused_bf16_launches) == (0, 0)
  _close("acc", _nhwc(acc), j16, j32)


def test_chain_wrappers_take_bf16_and_refuse_mixed_types():
  """Both wrappers take every input in bfloat16 (H*W and the width
  multiples of 8) or every input in float32; a mix of the two, float64,
  or a width that is a multiple of 4 but not of 8 in bfloat16 is refused
  before any launch, on the CPU as on the card."""
  _, _, block, x, h, eps = tfc._setup(True, True)
  ht = torch.from_numpy(h)
  with torch.no_grad():
    for dt in (torch.float32, BF16):
      wt, d = block.chain_mats(_nchw(x), ht, dt)
      neumann._check(_nchw(eps).to(dt), d, wt)
      fwd, biases, weights_t, hp = neumann.fused_chain_inputs(block, ht, dt)
      neumann._check_fused(_nchw(x).to(dt), _nchw(eps).to(dt), fwd, biases,
                           weights_t, hp)
    bad = [(_nchw(eps), d, wt),                       # float32 vareps
           (_nchw(eps).double(), [a.double() for a in d],
            [a.double() for a in wt])]
    for args in bad:
      with pytest.raises(ValueError, match="bfloat16|float32"):
        neumann._check(*args)
    with pytest.raises(ValueError, match="bfloat16"):
      neumann._check_fused(_nchw(x).to(BF16), _nchw(eps), fwd, biases,
                           weights_t, hp)
    # width 36: a multiple of 4 but not of 8
    narrow = torch_resflow.IResBlock(x.shape[-1], 36, cond_dim=16,
                                      preact=True)
    wt36, d36 = narrow.chain_mats(_nchw(x), ht)
    neumann._check(_nchw(eps), d36, wt36)
    wt36, d36 = narrow.chain_mats(_nchw(x), ht, BF16)
    with pytest.raises(ValueError, match="multiples of 8"):
      neumann._check(_nchw(eps).to(BF16), d36, wt36)


def test_fused_chain_scratch_bytes_match_the_source():
  """Kernel 8's scratch bytes (the wrapper's) against the formulas in
  `csrc/fused_chain.cu`'s comment: in bfloat16 the temporaries; in float32
  W1's and W1^T's TF32 planes (I8 = I rounded up to 8) in front of the
  temporaries, which are twice the bfloat16 ones."""
  text = " ".join(
      line.strip().lstrip("/").strip() for line in
      (Path(neumann.__file__).resolve().parents[1] / "csrc"
       / "fused_chain.cu").read_text().splitlines())
  formula = re.search(r"in bfloat16, (8\*B\*I\*H\*W .*?) bytes",
                      text).group(1)
  f32 = re.search(r"in float32, (16\*I\*I8 .*?) bytes", text).group(1)
  for b, c, hw, idim in [(128, 3, 32, 512), (128, 12, 16, 512), (4, 3, 8, 64),
                         (2, 12, 8, 36)]:
    names = dict(B=b, C=c, H=hw, W=hw, I=idim, I8=-(-idim // 8) * 8)
    assert eval(formula, {}, names) == neumann.fused_scratch_bytes(
        b, c, hw * hw, idim, BF16)
    got = neumann.fused_scratch_bytes(b, c, hw * hw, idim, torch.float32)
    assert got == eval(f32, {}, names)
    assert got == 2 * eval(formula, {}, names) + 16 * idim * names["I8"]


# ---- the chain-route block ----

SWITCHES = {"logdet_bf16": dict(chain_bf16=True),
            "mixed_precision": dict(mixed_precision=True)}


@pytest.mark.parametrize("fused_chain", [False, True])
@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_iresblock_chain_bf16_matches_jax(switch, fused_chain, monkeypatch):
  """The chain-route `IResBlock.forward` in bfloat16 (kernel 7 on
  `chain_mats`, or kernel 8 under the switch's flag; then one VJP through
  `g`, in bfloat16 under `flow.mixed_precision` only) against the JAX
  `IResBlock(chain_pallas=True)` under the same switch and the same noise,
  both traced with INDM_FUSED_CHAIN as the port runs. The log-det and,
  under `flow.logdet_bf16` (g in float32), the gradients of
  sum(logdet * q) with respect to x, h and every parameter are held at
  `_close` against JAX's bfloat16 and float32 blocks, and y to 1e-5.
  Under `flow.mixed_precision` the gradients run through the bfloat16
  net's double backward, whose products autograd rounds in another order
  than JAX's transposition: nearer JAX's bfloat16 block than JAX's float32
  block is (the bias and h gradients, sums of rounded products, reach 0.74
  of that gap, and JAX's own gap there exceeds 2e-2 of their scale); y
  within 2e-2 of g's scale and not the float32 block's (g's
  float32-bfloat16 gap is one rounding of its output). The chain ran in bfloat16 on both sides."""
  n = 3
  monkeypatch.setenv("INDM_FUSED_CHAIN", "1" if fused_chain else "0")
  _, params, block, x, h, eps = tfc._setup(True, True, seed=3)
  q = np.random.default_rng(9).normal(size=(x.shape[0],)).astype(np.float32)
  kind = "fused_neumann_chain" if fused_chain else "neumann_chain"
  mp = switch == "mixed_precision"

  def jax_run(bf16):
    nnet = LipschitzNNet(x.shape[-1], tfc.IDIM, kernels=(3, 1, 3), coeff=0.98,
                         act="sin", cond_dim=16, preact=True,
                         mixed_precision=bf16 and mp)
    jblock = IResBlock(nnet, n_dist="poisson", chain_pallas=True,
                       chain_bf16=bf16 and not mp)
    calls = []
    pallas = getattr(neumann_pallas, f"{kind}_pallas")

    def spy(*a, **k):
      calls.append(a[0].dtype)
      return pallas(*a, **k)

    monkeypatch.setattr(neumann_pallas, f"{kind}_pallas", spy)

    def loss(p, xx, hh):
      y, lp = jblock.forward({"nnet": p}, xx, jnp.zeros((xx.shape[0],)),
                             h=hh, train=True,
                             noise=(jnp.asarray(eps),
                                    jnp.asarray(n, jnp.int32)))
      return jnp.sum(-lp * q), (y, -lp)

    g = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)
    (_, (y, ld)), (gp, gx, gh) = (_strict(g) if bf16 else g)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
        jnp.asarray(h))
    monkeypatch.setattr(neumann_pallas, f"{kind}_pallas", pallas)
    assert calls == [jnp.bfloat16 if bf16 else jnp.float32]
    grads = convert._iresblock(block, {"nnet": jax.tree_util.tree_map(
        np.asarray, gp)})
    return ([np.asarray(y), np.asarray(ld), np.asarray(gx), np.asarray(gh)]
            + [grads[k].numpy() for k in sorted(grads)])

  j16, j32 = jax_run(True), jax_run(False)
  block.compute_dtype, block.mixed_precision = BF16, mp
  calls = []
  plain = getattr(neumann, f"{kind}_plain")
  monkeypatch.setattr(neumann, f"{kind}_plain",
                      lambda *a: calls.append(a[0].dtype) or plain(*a))
  xt = _nchw(x).requires_grad_()
  ht = torch.from_numpy(h).requires_grad_()
  y, ld = block(xt, ht, _nchw(eps), n, fused_chain=fused_chain)
  (ld * torch.from_numpy(q)).sum().backward()
  assert calls == [BF16]
  assert y.dtype == ld.dtype == torch.float32
  named = dict(block.named_parameters())
  port = ([_nhwc(y), ld.detach().numpy(), _nhwc(xt.grad), ht.grad.numpy()]
          + [named[k].grad.numpy() for k in sorted(named)])
  names = ["y", "logdet", "xbar", "hbar"] + sorted(named)
  if mp:
    scale = np.abs(j32[0] - x).max()
    assert np.abs(port[0] - j16[0]).max() <= BOUND * scale
    assert np.abs(port[0] - j32[0]).max() > 1e-6
  else:
    np.testing.assert_allclose(port[0], j16[0], rtol=1e-5, atol=1e-6)
  for name, a, b16, b32 in list(zip(names, port, j16, j32))[1:]:
    if not np.abs(b32).max():   # b2: the log-det does not depend on it
      assert not np.abs(a).max() and not np.abs(b16).max(), name
    elif mp and name != "logdet":
      err, gap = np.abs(a - b16).max(), np.abs(b32 - b16).max()
      assert err < gap, (name, err, gap)
    else:
      _close(name, a, b16, b32)


# ---- the tiny joint step under the chain route's benchmark flags ----

CHAIN_FLAGS = {"flow.fused_block": False, "flow.logdet_bf16": True,
               "flow.mixed_precision": True, "model.mixed_precision": True,
               "model.fast_dropout": True, "model.fused_groupnorm": False,
               "flow.intermediate_dim": 64}
F32 = {"flow.logdet_bf16": False, "flow.mixed_precision": False,
       "model.mixed_precision": False}


@pytest.fixture(scope="module", params=["0", "1"],
                ids=["kernel7", "fused_chain"])
def chain_step(request):
  """The JAX step at the tiny geometry (width 64, dropout 0) under the
  chain route's benchmark flags, compiled strictly, with INDM_FUSED_CHAIN
  as the param (read when the step is traced); the port's step on the same
  weights, batch and replayed noise, with a spy on the chain's plain
  versions; and the port's float32 step (the precision switches off),
  whose distance to JAX's bfloat16 step is the scale of what bfloat16
  changes (the port's float32 step matches JAX's to 1e-4,
  `test_torch_train_step.py`)."""
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv("INDM_FUSED_CHAIN", request.param)
    gen = tts.jax_step_setup(CHAIN_FLAGS, compiler_options=STRICT)
    s = next(gen)
    calls = {}
    for name in ("neumann_chain_plain", "fused_neumann_chain_plain"):
      fn = getattr(neumann, name)

      def spy(*a, _fn=fn, _name=name):
        cdt = a[6] if _name == "neumann_chain_plain" and len(a) > 6 else None
        calls.setdefault(_name, []).append((a[0].dtype, cdt))
        return _fn(*a)

      mp.setattr(neumann, name, spy)
    port = tts.run_port_step(s)
    mp.undo()
    mp.setenv("INDM_FUSED_CHAIN", request.param)
    tc32 = copy.deepcopy(s["tc"])
    for k, v in F32.items():
      tts._set(tc32, k, v)
    port32 = tts.run_port_step({**s, "tc": tc32})
    yield s, port, port32, calls, request.param
    next(gen, None)


def test_chain_step_took_the_bf16_chain(chain_step):
  """The port's step ran every block's chain in bfloat16: the kernel-7
  route's plain version on bfloat16 inputs four times, or under
  INDM_FUSED_CHAIN=1 kernel 8's four times (each with kernel 7's plain
  chain inside in bfloat16 on float32-held values)."""
  _, _, _, calls, switch = chain_step
  if switch == "0":
    assert calls == {"neumann_chain_plain": [(BF16, None)] * 4}
  else:
    assert calls == {"fused_neumann_chain_plain": [(BF16, None)] * 4,
                     "neumann_chain_plain": [(torch.float32, BF16)] * 4}


def test_chain_step_losses_match(chain_step):
  """Per-example losses against `step_nll` under the same flags: every
  term within 2e-2 of its scale, losses = score + flow + logp; the flow
  term (the bfloat16 chain's log-dets) also nearer JAX's bfloat16 step
  than half of its gap to the float32 step. (The prior term's gap is one
  float32 rounding here: at the VP SDE's end time log p of the diffused z
  hardly depends on z, and the chain route's z differs between the modes
  only by g's bfloat16 output.)"""
  s, (_, _, aux), (_, _, aux32), _, _ = chain_step
  for name, want in zip(tts.torch_joint.METRICS, s["metrics"]):
    got = aux[name].detach().numpy()
    assert np.isfinite(got).all(), name
    err = np.abs(got - want).max()
    assert err <= BOUND * np.abs(want).max(), name
    if name == "losses_flow":
      gap = np.abs(aux32[name].detach().numpy() - want).max()
      assert err < 0.5 * gap, (name, err, gap)
  np.testing.assert_allclose(
      aux["losses"].detach().numpy(),
      (aux["losses_score"] + aux["losses_flow"]
       + aux["losses_logp"]).detach().numpy(), rtol=1e-5)


def test_chain_step_gradients_match(chain_step):
  """Both nets' gradients before any update against JAX's bfloat16 step:
  per net, the largest error at most twice the largest difference between
  the float32 step and JAX's bfloat16 step, the criterion of
  `test_torch_bf16.test_bench_step_gradients_match`."""
  s, (score, flow, _), (score32, flow32, _), _, _ = chain_step
  pairs = list(tts._grad_pairs(s, (score, flow, None)))
  g32 = {name: p.grad for m in (score32, flow32)
         for name, p in m.named_parameters()}
  assert len(pairs) > 100
  flow_names = dict(flow.named_parameters())
  err, gap = {"score": 0.0, "flow": 0.0}, {"score": 0.0, "flow": 0.0}
  for name, p, want in pairs:
    net = "flow" if name in flow_names else "score"
    assert torch.isfinite(p.grad).all(), name
    err[net] = max(err[net], (p.grad - want).abs().max().item())
    gap[net] = max(gap[net], (g32[name] - want).abs().max().item())
  for net in err:
    assert gap[net] > 0, net
    assert err[net] <= 2 * gap[net], (net, err[net], gap[net])


# ---- flow.logdet_unroll ----

@pytest.mark.parametrize("route", ["chain", "fused_chain", "fused_pair"])
def test_iresblock_honors_unroll_terms(route, monkeypatch):
  """With a draw n = 6 larger than the unroll, `IResBlock.forward` with
  unroll_terms = 4 gives JAX's log-det under `flow.logdet_unroll=4` on
  each kernel route (`test_neumann_pallas.py:140`): the chain, the fully
  fused chain and the fused pair, rtol and atol 1e-4; the kernels ran
  n + 2 = 4 terms, not 8."""
  n = 6
  monkeypatch.setenv("INDM_FUSED_CHAIN", "1" if route == "fused_chain"
                     else "0")
  nnet, params, block, x, h, eps = tfc._setup(True, True, seed=4)
  block.unroll_terms = 4
  block.fused_block = route == "fused_pair"
  jblock = IResBlock(nnet, n_dist="poisson", chain_pallas=True,
                     unroll_terms=4, fused_block=route == "fused_pair")
  _, lp = jblock.forward({"nnet": jax.tree_util.tree_map(jnp.asarray,
                                                          params)},
                         jnp.asarray(x), jnp.zeros((x.shape[0],)),
                         h=jnp.asarray(h), train=True,
                         noise=(jnp.asarray(eps), jnp.asarray(n, jnp.int32)))
  terms = []
  coeffs = neumann.chain_coeffs
  monkeypatch.setattr(neumann, "chain_coeffs",
                      lambda n, *a: terms.append(n + a[0]) or coeffs(n, *a))
  with torch.no_grad():
    _, ld = block(_nchw(x), torch.from_numpy(h), _nchw(eps), n,
                  fused_chain=route == "fused_chain")
  assert terms and set(terms) == {4}
  np.testing.assert_allclose(ld.numpy(), -np.asarray(lp), rtol=1e-4,
                             atol=1e-4)


def test_stack_honors_unroll_terms(monkeypatch):
  """`fused_stack_forward` hands the stack kernels each block's draw
  clipped to unroll_terms - 2 (`resflow.py:917-919`), and gives the stack
  the draws clipped by hand give."""
  flow = torch_resflow.ResidualFlow(8, 3, n_blocks=(3, 2),
                                    intermediate_dim=64, fused_block=True,
                                    unroll_terms=4)
  x = torch.randn(2, 3, 8, 8, generator=torch.Generator().manual_seed(0))
  noise = [(v, 5 + i) for i, (v, _) in enumerate(flow.sample_noise(
      x.shape, torch.Generator().manual_seed(1), np.random.default_rng(2)))]
  seen = []
  fn = pfb.FusedBlockFn.apply
  stack_fn = torch_resflow.stack_lib.FusedStackFn.apply
  monkeypatch.setattr(torch_resflow.stack_lib.FusedStackFn, "apply",
                      lambda *a: seen.append(list(a[9])) or stack_fn(*a))
  monkeypatch.setattr(pfb.FusedBlockFn, "apply",
                      lambda *a: seen.append([a[9]]) or fn(*a))
  with torch.no_grad():
    _, logpx = flow.fwdpass(x, None, noise)
    for b in flow.blocks():
      b.unroll_terms = 0
    _, want = flow.fwdpass(x, None, [(v, min(n, 2)) for v, n in noise])
  assert seen[:3] == [[2], [2, 2], [2, 2]]
  torch.testing.assert_close(logpx, want, rtol=0, atol=0)
