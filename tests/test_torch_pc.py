"""The port's score side against the JAX package: the subVP and
GeometricVP SDEs (and the VP SDE's tables), every `get_score_fn` branch,
every predictor and corrector on every SDE the JAX package runs it on, the
PC sampler's plain, linear-SNR, denoise-search and extra-step rounds, the
sample cache with its PNG grid, one whole VP PC round of the tiny nets,
the sampling CLI's denoise search, and the refusals that remain, each
shown to fail in the JAX package too.

Every random draw of the JAX functions is rebuilt from its key and handed
to the port. Away from the whole round, an analytic score stands in for
the net on both sides (the nets are held elsewhere), so that only the
sampler's arithmetic is compared; the score-function branches take a
stand-in net that records its labels. Tolerances: 1e-6 for the SDE
formulas (1e-5 where `tests/test_sde.py` uses it); the samplers' float32
steps within 1e-5 of their largest value; whole rounds within 1e-4, as
`tests/test_torch_ve.py` holds the VE round.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import test_torch_ve as tve
from indm_torch import configs as torch_configs
from indm_torch import run_lib as torch_run_lib
from indm_torch import sample as torch_sample
from indm_torch import sampling as torch_sampling
from indm_torch import sampling_io as torch_io
from indm_torch import sde as torch_sde
from indm_torch.models import registry as torch_registry
from indm_tpu import configs as jax_configs
from indm_tpu import sampling as jax_sampling
from indm_tpu import sampling_io as jax_io
from indm_tpu import sde as jax_sde
from indm_tpu.models import registry as jax_registry
from torch_threads import one_torch_thread  # noqa: F401

SHAPE = (4, 4, 4, 2)       # NHWC
SDES = ("vpsde", "subvpsde", "vesde", "gvpsde")
SDE_RTOL = 1e-6
STEP_RTOL = 1e-5
ROUND_RTOL = 1e-4
# the sampler tests: the SDEs' N (VP's DDPM betas stay below 1 from N =
# 21 on) and the plain loop's sampling.num_scales
N_SCALES = 50
SCALES = 5


def _nchw(a):
  return torch.from_numpy(np.ascontiguousarray(
      np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
  return t.detach().permute(0, 2, 3, 1).numpy()


def configs(sde="vpsde", n=N_SCALES, scales=SCALES, **leaves):
  """Both packages' configs, `ve/CIFAR10/indm` under VESDE and
  `vp/CIFAR10/indm_nll` under the VP kinds, with `training.sde`, N =
  `model.num_scales` = n, `sampling.num_scales` = scales and `leaves`
  set."""
  name = "ve/CIFAR10/indm" if sde == "vesde" else "vp/CIFAR10/indm_nll"
  jc, tc = jax_configs.get_config(name), torch_configs.get_config(name)
  for c in (jc, tc):
    c.training.sde = sde
    c.model.num_scales = n
    c.sampling.num_scales = scales
    for k, v in leaves.items():
      tve._set(c, k, v)
  return jc, tc


def sdes(name, n=1000):
  jc, tc = configs(name, n)
  return jax_sde.get_sde(jc), torch_sde.get_sde(tc)


def close(got, want, rtol):
  """`got` (torch or numpy) within rtol of `want`'s largest magnitude."""
  got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
  want = np.asarray(want)
  scale = max(np.abs(want).max(), 1e-30)
  np.testing.assert_allclose(got / scale, want / scale, atol=rtol)


# ---------------------------------------------------------------------------
# the SDEs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["vpsde", "subvpsde", "gvpsde"])
def test_sde_methods_match_jax(name):
  """sde, marginal_prob, prior_logp, prior_sampling (replayed noise and a
  data mean, which VP and GeometricVP add and subVP does not read),
  discretize (the DDPM table, the explicit next_t, the Euler-Maruyama
  default of subVP), the reverse SDE and ODE with a linear score, the
  diffusion time, the tables, integral_beta, antiderivative and the
  normalising constant where the SDE has them, at rtol 1e-6 (the VP
  marginal's std at 1e-5, as `tests/test_sde.py:31`)."""
  j, t = sdes(name)
  rng = np.random.default_rng(0)
  x = rng.normal(size=SHAPE).astype(np.float32)
  grid = np.asarray(jnp.linspace(1.0, 1e-5, 1000))
  ts = grid[[0, 1, 400, 998]]
  xj, xt, tj, tt = jnp.asarray(x), _nchw(x), jnp.asarray(ts), torch.tensor(ts)

  (dj, gj), (dt, gt) = j.sde(xj, tj), t.sde(xt, tt)
  close(_nhwc(dt), dj, SDE_RTOL)
  np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=SDE_RTOL)
  (mj, sj), (mt, st) = j.marginal_prob(xj, tj), t.marginal_prob(xt, tt)
  close(_nhwc(mt), mj, SDE_RTOL)
  np.testing.assert_allclose(st.numpy(), np.asarray(sj),
                             rtol=1e-5 if name == "vpsde" else SDE_RTOL)
  np.testing.assert_allclose(t.prior_logp(xt * 3).numpy(),
                             np.asarray(j.prior_logp(xj * 3)), rtol=SDE_RTOL)
  key = jax.random.PRNGKey(4)
  mean = x[:1] * 0.1
  pj = j.prior_sampling(key, SHAPE, jnp.asarray(mean))
  pt = t.prior_sampling(None, device="cpu", noise=_nchw(jax.random.normal(
      key, SHAPE)), data_mean=_nchw(mean)[0])
  np.testing.assert_allclose(_nhwc(pt), np.asarray(pj), rtol=SDE_RTOL)

  nexts = [ts / 2, grid[[1, 2, 401, 999]]]
  for nt in nexts if name == "gvpsde" else [None] + nexts:
    fj, Gj = j.discretize(xj, tj, None if nt is None else jnp.asarray(nt))
    ft, Gt = t.discretize(xt, tt, None if nt is None else torch.tensor(nt))
    close(_nhwc(ft), fj, SDE_RTOL)
    np.testing.assert_allclose(Gt.numpy(), np.asarray(Gj), rtol=SDE_RTOL)

  score_j = lambda x, t: -x * (1.0 + t[:, None, None, None])
  score_t = lambda x, t: -x * (1.0 + t[:, None, None, None])
  for pf in (False, True):
    rj, rt = j.reverse(score_j, pf), t.reverse(score_t, pf)
    (aj, bj), (at, bt) = rj.sde(xj, tj), rt.sde(xt, tt)
    close(_nhwc(at), aj, SDE_RTOL)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=SDE_RTOL)
    nt = grid[[1, 2, 401, 999]]
    (fj, Gj), (ft, Gt) = (rj.discretize(xj, tj, jnp.asarray(nt)),
                          rt.discretize(xt, tt, torch.tensor(nt)))
    close(_nhwc(ft), fj, SDE_RTOL)
    np.testing.assert_allclose(Gt.numpy(), np.asarray(Gj), rtol=SDE_RTOL)

  u = np.asarray(jax.random.uniform(key, (4,)))
  for imp in (False, True):
    tj2, zj2 = j.get_diffusion_time(key, 4, j.eps, imp)
    tt2, zt2 = t.get_diffusion_time(4, t.get_t_min(device="cpu"), imp,
                                    u=torch.from_numpy(u))
    np.testing.assert_allclose(tt2.numpy(), np.asarray(tj2), rtol=SDE_RTOL,
                               atol=1e-9)
    np.testing.assert_allclose(float(zt2), float(zj2), rtol=SDE_RTOL)
  if name == "subvpsde":
    assert not hasattr(t, "alphas") and not hasattr(t, "antiderivative")
    return
  for table in ("discrete_betas", "alphas", "alphas_cumprod",
                "sqrt_alphas_cumprod", "sqrt_1m_alphas_cumprod"):
    np.testing.assert_array_equal(getattr(t, table).numpy(),
                                  np.asarray(getattr(j, table)), table)
  for fn in ("integral_beta", "antiderivative"):
    np.testing.assert_allclose(getattr(t, fn)(tt).numpy(),
                               np.asarray(getattr(j, fn)(tj)),
                               rtol=SDE_RTOL, atol=1e-7)
  np.testing.assert_allclose(float(t.normalizing_constant(1e-5)),
                             float(j.normalizing_constant(1e-5)),
                             rtol=SDE_RTOL)


def test_get_sde_takes_all_four_names():
  kinds = {"vpsde": torch_sde.VPSDE, "subvpsde": torch_sde.subVPSDE,
           "vesde": torch_sde.VESDE, "gvpsde": torch_sde.GeometricVPSDE}
  for name, kind in kinds.items():
    assert type(sdes(name)[1]) is kind
  assert isinstance(sdes("gvpsde")[1], torch_sde.VPSDE)
  _, tc = configs("cld")
  with pytest.raises(NotImplementedError):
    torch_sde.get_sde(tc)


# ---------------------------------------------------------------------------
# the score function's branches
# ---------------------------------------------------------------------------


class _JaxNet:
  """A stand-in for the flax module: its output is x times a function of
  the labels, so that every label and std reaches the score."""

  def apply(self, variables, x, labels, train=False, rngs=None):
    lab = jnp.asarray(labels, jnp.float32)
    return x * (1.0 + 0.01 * lab)[:, None, None, None] + 0.5


def _torch_net(x, labels, generator=None):
  lab = labels.to(torch.float32)
  return x * (1.0 + 0.01 * lab)[:, None, None, None] + 0.5


@pytest.mark.parametrize("name,continuous,unbounded,ddpm_score", [
    ("vpsde", True, False, True), ("vpsde", False, False, True),
    ("vpsde", True, True, True), ("vpsde", True, False, False),
    ("subvpsde", False, False, True), ("gvpsde", True, False, True),
    ("gvpsde", False, False, True), ("gvpsde", True, True, True),
    ("vesde", True, False, True), ("vesde", False, False, True)])
def test_score_fn_branches_match_jax(name, continuous, unbounded,
                                     ddpm_score):
  """Each branch of `get_score_fn` (`indm_tpu/models/registry.py:98-140`)
  with a stand-in net: the labels t * 999, t * (N - 1) with the DDPM std
  table, the antiderivative's labels (`training.unbounded_parametrization`
  at `training.stabilizing_constant` 1e-3), subVP's continuous branch
  whatever `continuous` says, sigma(t) and round((T - t) (N - 1)) under
  VE, with and without `training.ddpm_score`: within 1e-5 of the largest
  score (float32 formulas; the stabilised antiderivative's log)."""
  jc, tc = configs(name, 1000, **{
      "training.unbounded_parametrization": unbounded,
      "training.stabilizing_constant": 1e-3,
      "training.ddpm_score": ddpm_score})
  j, t = jax_sde.get_sde(jc), torch_sde.get_sde(tc)
  x = np.random.default_rng(1).normal(size=SHAPE).astype(np.float32)
  ts = np.asarray(jnp.linspace(1.0, 1e-5, 1000))[[0, 3, 500, 999]]
  fj = jax_registry.get_score_fn(jc, j, _JaxNet(), {}, continuous=continuous)
  ft = torch_registry.get_score_fn(tc, t, _torch_net, continuous=continuous)
  close(_nhwc(ft(_nchw(x), torch.tensor(ts))),
        fj(jnp.asarray(x), jnp.asarray(ts)), STEP_RTOL)


def test_model_fn_is_the_raw_net():
  net = torch.nn.Conv2d(2, 2, 1)
  x = torch.randn(2, 2, 4, 4)
  fn = torch_registry.get_model_fn(lambda x, labels, g: net(x) * labels[0])
  labels = torch.tensor([3, 3])
  torch.testing.assert_close(fn(x, labels), net(x) * 3)
  assert not fn(x, labels).requires_grad
  assert torch_registry.get_model_fn(
      lambda x, labels, g: net(x), train=True)(x, labels).requires_grad


# ---------------------------------------------------------------------------
# predictors and correctors, one update each, with an analytic score
# ---------------------------------------------------------------------------


def score_pair(t_scale=1.0):
  """(JAX, torch) analytic scores: -x (1 + t) + 0.1 sin x."""
  def sj(x, t, rng=None):
    return -x * (1.0 + t_scale * t[:, None, None, None]) + 0.1 * jnp.sin(x)

  def st(x, t, generator=None):
    return -x * (1.0 + t_scale * t[:, None, None, None]) + 0.1 * torch.sin(x)
  return sj, st


PREDICTOR_CASES = [(s, p, pf) for s in SDES for p, pf in (
    ("euler_maruyama", False), ("euler_maruyama", True),
    ("reverse_diffusion", False), ("reverse_diffusion", True),
    ("ancestral_sampling", False), ("none", False))
                   if not (s == "subvpsde" and p == "ancestral_sampling")]


@pytest.mark.parametrize("name,predictor,pf", PREDICTOR_CASES)
def test_predictor_matches_jax(name, predictor, pf):
  """One update of each predictor on each SDE that the JAX package runs it
  on (with and without the probability flow where it takes one), with the
  JAX draw replayed: without next_t, and with it where the predictor
  reads it (reverse_diffusion; GeometricVP's needs it). The JAX update
  runs eagerly: compiled, XLA moves GeometricVP's beta(1), whose
  denominator is 1e-3, by 2.2e-5 of itself from its eager value, which
  the port computes to the bit."""
  j, t = sdes(name, N_SCALES)
  sj, st = score_pair()
  x = 2 * np.random.default_rng(2).normal(size=SHAPE).astype(np.float32)
  grid = np.asarray(jnp.linspace(1.0, 1e-5, SCALES))
  key = jax.random.PRNGKey(5)
  z = _nchw(jax.random.normal(key, SHAPE))
  pj = jax_sampling.get_predictor(predictor)(j, sj, pf)
  pt = torch_sampling.get_predictor(predictor)(t, st, pf)
  nexts = [None, 2] if predictor == "reverse_diffusion" else [None]
  if name == "gvpsde" and predictor == "reverse_diffusion":
    nexts = [2]
  for i in (0, 2, SCALES - 1):
    for nxt in nexts:
      vt = np.full((SHAPE[0],), grid[i], np.float32)
      vn = None if nxt is None else np.full(
          (SHAPE[0],), grid[min(i + 1, SCALES - 1)], np.float32)
      out_j = pj(key, jnp.asarray(x), jnp.asarray(vt),
                 None if vn is None else jnp.asarray(vn))
      out_t = pt(_nchw(x), torch.tensor(vt),
                 None if vn is None else torch.tensor(vn), noise=z)
      for ours, theirs in zip(out_t, out_j):
        close(_nhwc(ours), theirs, STEP_RTOL)


CORRECTOR_CASES = [(s, c) for s in SDES for c in ("langevin", "ald", "none")
                   if not (s == "subvpsde" and c != "none")]


@pytest.mark.parametrize("name,corrector", CORRECTOR_CASES)
def test_corrector_matches_jax(name, corrector):
  """Two steps of each corrector on each SDE the JAX package runs it on
  (alpha from the DDPM table under VP and GeometricVP, 1 under VE), at
  the corrector's snr and at an explicit snr_t, with the draws replayed:
  each step's normal from split(key)."""
  j, t = sdes(name, N_SCALES)
  sj, st = score_pair()
  x = 2 * np.random.default_rng(3).normal(size=SHAPE).astype(np.float32)
  grid = np.asarray(jnp.linspace(1.0, 1e-5, SCALES))
  key = jax.random.PRNGKey(6)
  noise, rng = [], key
  for _ in range(2):
    rng, step_rng = jax.random.split(rng)
    noise.append(_nchw(jax.random.normal(step_rng, SHAPE)))
  cj = jax_sampling.get_corrector(corrector)(j, sj, 0.16, 2)
  ct = torch_sampling.get_corrector(corrector)(t, st, 0.16, 2)
  for i in (0, 2, SCALES - 1):
    vt = np.full((SHAPE[0],), grid[i], np.float32)
    for snr in (None, 0.2):
      out_j = cj(key, jnp.asarray(x), jnp.asarray(vt), snr)
      out_t = ct(_nchw(x), torch.tensor(vt), snr, noise=noise)
      for ours, theirs in zip(out_t, out_j):
        close(_nhwc(ours), theirs, STEP_RTOL)


# ---------------------------------------------------------------------------
# whole rounds with an analytic score
# ---------------------------------------------------------------------------


def replay_steps(rng, steps, shape, n_steps):
  """The draws of `steps` corrector-predictor steps of the JAX PC loops
  from `rng` (per step split(rng, 3) -> rng, corrector, predictor; the
  corrector's steps split once more each): [(corrector draws, predictor
  draw)] in NCHW, and the rng after them."""
  out = []
  for _ in range(steps):
    rng, c_rng, p_rng = jax.random.split(rng, 3)
    c = []
    for _ in range(n_steps):
      c_rng, step_rng = jax.random.split(c_rng)
      c.append(_nchw(jax.random.normal(step_rng, shape)))
    out.append((c, _nchw(jax.random.normal(p_rng, shape))))
  return out, rng


def jax_round(jc, before=None, final_time=0.0, seed=11, flow=False):
  """One round of the config's JAX PC sampler with the analytic score
  (with `flow` a stand-in flow inverse x / 2 + 0.1; the inverse scaler
  (x + 1) / 2) from PRNGKey(seed); `before` (NHWC) is the cached state it
  resumes from."""
  sampler = jax_sampling.get_sampling_fn(jc, jax_sde.get_sde(jc), SHAPE,
                                         lambda x: (x + 1.0) / 2.0, 1e-5)
  inv = (lambda x: x * 0.5 + 0.1) if flow else None
  return jax.jit(lambda r, b, f: sampler(
      r, score_pair()[0], inv, before_data=b, final_time=f))(
          jax.random.PRNGKey(seed),
          None if before is None else jnp.asarray(before),
          jnp.float32(final_time))


def torch_round(tc, before=None, final_time=0.0, seed=11, flow=False):
  """The same round of the port's sampler on the CPU, replaying the JAX
  draws of PRNGKey(seed)."""
  t_sde = torch_sde.get_sde(tc)
  nchw = (SHAPE[0], SHAPE[3], SHAPE[1], SHAPE[2])
  sampler = torch_sampling.get_sampling_fn(tc, t_sde, nchw,
                                           lambda x: (x + 1.0) / 2.0, 1e-5,
                                           device="cpu")
  variant = torch_sampling.pc_variant(tc)
  rng, prior, first = jax.random.PRNGKey(seed), None, 0
  if before is None:
    rng, prior_rng = jax.random.split(rng)
    prior = _nchw(jax.random.normal(prior_rng, SHAPE))
    first = {"plain": tc.sampling.num_scales, "search": t_sde.N - 1,
             "more_step": t_sde.N}[variant]
  extra = 100 if variant == "more_step" and not tc.sampling.need_sample \
      else 0
  steps, _ = replay_steps(rng, first + extra, SHAPE,
                          tc.sampling.n_steps_each)
  return sampler(score_pair()[1], (lambda x: x * 0.5 + 0.1) if flow else None,
                 prior_noise=prior, step_noise=steps.__getitem__,
                 before_data=None if before is None else _nchw(before),
                 final_time=final_time)


def round_pair(jc, tc, **kw):
  return torch_round(tc, **kw), jax_round(jc, **kw)


def check_round(out_t, out_j, rtol=ROUND_RTOL):
  assert out_t[3] == int(out_j[3])
  assert (out_t[2] is None) == (out_j[2] is None)
  for ours, theirs in zip(out_t[:3], out_j[:3]):
    if theirs is not None:
      assert tuple(ours.shape) == tuple(theirs.shape)
      close(ours, theirs, rtol)


ROUND_CASES = {
    # (sde, leaves): every SDE's plain round with its config's pair
    "vp-euler-langevin": ("vpsde", {"sampling.predictor": "euler_maruyama",
                                    "sampling.corrector": "langevin"}),
    "vp-ancestral-ald": ("vpsde", {"sampling.predictor":
                                   "ancestral_sampling",
                                   "sampling.corrector": "ald",
                                   "sampling.n_steps_each": 2}),
    "subvp-euler": ("subvpsde", {"sampling.predictor": "euler_maruyama",
                                 "sampling.corrector": "none"}),
    "subvp-reverse": ("subvpsde", {"sampling.predictor": "reverse_diffusion",
                                   "sampling.corrector": "none"}),
    "gvp-euler-langevin": ("gvpsde", {"sampling.predictor": "euler_maruyama",
                                      "sampling.corrector": "langevin"}),
    "gvp-ancestral-ald": ("gvpsde", {"sampling.predictor":
                                     "ancestral_sampling",
                                     "sampling.corrector": "ald"}),
    "ve-linear-snr": ("vesde", {"sampling.snr_scheduling": "linear",
                                "sampling.begin_snr": 0.3,
                                "sampling.end_snr": 0.05}),
    "vp-linear-snr": ("vpsde", {"sampling.predictor": "reverse_diffusion",
                                "sampling.corrector": "langevin",
                                "sampling.snr_scheduling": "linear",
                                "sampling.begin_snr": 0.1,
                                "sampling.end_snr": 0.2}),
    "ve-num-scales": ("vesde", {"sampling.num_scales": 3}),
    "vp-no-denoise": ("vpsde", {"sampling.predictor": "euler_maruyama",
                                "sampling.corrector": "langevin",
                                "sampling.noise_removal": False}),
}


@pytest.mark.parametrize("case", sorted(ROUND_CASES))
def test_plain_round_matches_jax(case):
  """The plain loop (and its step-(N-2) mean) on each SDE with the
  flow stand-in, the linear SNR schedule in float32, sampling.num_scales
  below sde.N (the Euler step and the evaluation count stay sde.N's), and
  without noise_removal."""
  name, leaves = ROUND_CASES[case]
  jc, tc = configs(name, **{"sampling.method": "pc", **leaves})
  check_round(*round_pair(jc, tc, flow=True))


VARIANT_CASES = [
    (sde, variant, need, resume)
    for sde, variant in (("vesde", "search"), ("gvpsde", "search"),
                         ("vpsde", "search"), ("vesde", "more_step"),
                         ("vpsde", "more_step"))
    for need, resume in ((False, True), (False, False), (True, False))]


@pytest.mark.parametrize("name,variant,need_sample,resume", VARIANT_CASES)
def test_search_and_more_step_rounds_match_jax(name, variant, need_sample,
                                               resume):
  """The denoise search (`sampling.pc_denoise`: N - 1 steps with next_t,
  then the probability flow's mean to `final_time` 0.3 unless
  `sampling.need_sample`) and the extra steps (`sampling.more_step`: N
  steps, then 100 log-spaced ones), from the prior or resumed from a
  cached state (`before_data`)."""
  leaves = {"sampling.method": "pc", "sampling.need_sample": need_sample,
            f"sampling.{'pc_denoise' if variant == 'search' else 'more_step'}":
                True}
  if name != "vesde":
    leaves.update({"sampling.predictor": "reverse_diffusion",
                   "sampling.corrector": "langevin"})
  jc, tc = configs(name, **leaves)
  before = (np.random.default_rng(4).normal(size=SHAPE).astype(np.float32)
            if resume else None)
  out_t, out_j = round_pair(jc, tc, before=before, final_time=0.3)
  check_round(out_t, out_j)


def test_pc_variants_take_their_sde_n_grid():
  """The search variant runs on the sde.N grid whatever
  `sampling.num_scales` is, as the JAX sampler does."""
  jc, tc = configs("vesde", **{"sampling.method": "pc",
                               "sampling.pc_denoise": True,
                               "sampling.need_sample": False})
  tc.sampling.num_scales = jc.sampling.num_scales = 3
  check_round(*round_pair(jc, tc, final_time=0.0))


# ---------------------------------------------------------------------------
# what raises, in both packages
# ---------------------------------------------------------------------------


REFUSALS = {
    "langevin-on-subvp": ("subvpsde", {"sampling.corrector": "langevin"}),
    "ald-on-subvp": ("subvpsde", {"sampling.corrector": "ald"}),
    "ancestral-on-subvp": ("subvpsde", {"sampling.predictor":
                                        "ancestral_sampling"}),
    "ancestral-probability-flow": ("vpsde", {
        "sampling.predictor": "ancestral_sampling",
        "sampling.probability_flow": True}),
    "reverse-diffusion-plain-on-gvp": ("gvpsde", {
        "sampling.predictor": "reverse_diffusion"}),
    "unknown-snr-scheduling": ("vesde", {"sampling.snr_scheduling": "cos"}),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_fail_in_jax_too(case):
  """Each combination the port refuses fails in the JAX package's sampler
  too, and the port's message names it."""
  name, leaves = REFUSALS[case]
  jc, tc = configs(name, **{"sampling.method": "pc",
                            "sampling.corrector": "none", **leaves})
  with pytest.raises(Exception):
    jax_round(jc)
  with pytest.raises((NotImplementedError, ValueError)) as err:
    torch_round(tc)
  words = {"langevin-on-subvp": "subVPSDE", "ald-on-subvp": "subVPSDE",
           "ancestral-on-subvp": "subVPSDE",
           "ancestral-probability-flow": "probability_flow",
           "reverse-diffusion-plain-on-gvp": "next_t",
           "unknown-snr-scheduling": "cos"}
  assert words[case] in str(err.value)


@pytest.mark.parametrize("case", ["unbounded-on-subvp"])
def test_score_fn_refusal_fails_in_jax_too(case):
  jc, tc = configs("subvpsde", **{"training.unbounded_parametrization":
                                  True})
  j, t = jax_sde.get_sde(jc), torch_sde.get_sde(tc)
  x, ts = np.ones(SHAPE, np.float32), np.full((SHAPE[0],), 0.5, np.float32)
  with pytest.raises(AttributeError):
    jax_registry.get_score_fn(jc, j, _JaxNet(), {}, continuous=True)(
        jnp.asarray(x), jnp.asarray(ts))
  with pytest.raises(NotImplementedError, match="antiderivative"):
    torch_registry.get_score_fn(tc, t, _torch_net, continuous=True)(
        _nchw(x), torch.tensor(ts))


# ---------------------------------------------------------------------------
# the sample cache and the PNG grid
# ---------------------------------------------------------------------------


def _fake_round(calls, torch_side, n=4):
  """A sampling round that records its resume arguments and returns fixed
  images (before, after, search, nfe), NHWC in [0, 1]."""
  g = np.random.default_rng(7)
  before = g.uniform(size=(n, 8, 8, 3)).astype(np.float32)
  after = g.uniform(size=(n, 8, 8, 3)).astype(np.float32)
  search = g.uniform(size=(n, 8, 8, 3)).astype(np.float32)

  def sample_round(rng=None, temperature=1.0, data_mean=None,
                   before_data=None, final_time=0.0):
    calls.append((None if before_data is None else np.asarray(before_data),
                  float(final_time)))
    if torch_side:
      return (torch.from_numpy(before), torch.from_numpy(after),
              torch.from_numpy(search), 7)
    return jnp.asarray(before), jnp.asarray(after), jnp.asarray(search), 7
  return sample_round


def _cache_config(sde, **leaves):
  jc, tc = configs(sde, **leaves)
  for c in (jc, tc):
    c.data.image_size = 8
  return jc, tc


@pytest.mark.parametrize("sde,leaves", [
    ("vesde", {}), ("vesde", {"sampling.pc_denoise": True,
                              "sampling.pc_denoise_time": 0.25}),
    ("vpsde", {"sampling.pc_denoise": True}),
    ("vesde", {"sampling.more_step": True})])
def test_sample_cache_matches_jax(tmp_path, sde, leaves):
  """`get_samples` on both sides into two directories holding the same
  cached files: the files each writes (names and bytes of their arrays),
  the resume it makes (under pc_denoise the VE step-(N-2) file, else the
  base before-flow file, handed over in the model's scale NCHW; the final
  time), the skip of a cached round and the flow inverse re-applied in
  chunks of 16 to a cached before-flow file; then `load_all_samples`."""
  jc, tc = _cache_config(sde, **leaves)
  dirs = {k: tmp_path / k for k in ("jax", "torch")}
  cached = np.random.default_rng(8).integers(0, 256, (4, 8, 8, 3),
                                             dtype=np.uint8)
  for d in dirs.values():
    d.mkdir()
    for name in ("samples_0_before_flow.npz",
                 "samples_0_before_flow_for_search.npz"):
      np.savez_compressed(d / name, samples=cached)
  calls = {"jax": [], "torch": []}
  got_j = jax_io.get_samples(jc, None, _fake_round(calls["jax"], False), 0,
                             0, str(dirs["jax"]), rng=jax.random.PRNGKey(0))
  got_t = torch_io.get_samples(tc, None, _fake_round(calls["torch"], True),
                               0, str(dirs["torch"]))
  np.testing.assert_array_equal(got_t["after"], got_j)
  assert len(calls["jax"]) == len(calls["torch"])
  for (bj, fj), (bt, ft) in zip(calls["jax"], calls["torch"]):
    assert fj == ft
    if bj is None:
      assert bt is None
    else:
      np.testing.assert_array_equal(bt.transpose(0, 2, 3, 1), bj)
  files = {k: sorted(os.listdir(d)) for k, d in dirs.items()}
  assert files["jax"] == files["torch"]
  for name in files["jax"]:
    if name.endswith(".npz"):
      with np.load(dirs["jax"] / name) as a, np.load(dirs["torch"] / name) \
          as b:
        np.testing.assert_array_equal(a["samples"], b["samples"], name)
  # a second call finds the after-flow file and samples nothing
  again = torch_io.get_samples(tc, None, lambda **k: 1 / 0, 0,
                               str(dirs["torch"]))
  assert again["cached"] == "after"
  np.testing.assert_array_equal(again["after"], got_t["after"])
  np.testing.assert_array_equal(
      torch_io.load_all_samples(tc, str(dirs["torch"])),
      jax_io.load_all_samples(jc, str(dirs["jax"])))


def test_flow_inverse_reapplied_to_a_cached_before_file(tmp_path):
  """A round with only its before-flow file: the flow inverse again in
  chunks of 16 (20 images: 16 + 4), temperature 0.9, equal to JAX's
  bytes."""
  jc, tc = _cache_config("vpsde")
  cached = np.random.default_rng(9).integers(0, 256, (20, 8, 8, 3),
                                             dtype=np.uint8)
  out = {}
  for side in ("jax", "torch"):
    d = tmp_path / side
    d.mkdir()
    np.savez_compressed(d / "samples_3_before_flow.npz", samples=cached)
  sizes = []

  def inv_t(x):
    sizes.append(x.shape[0])
    return x * 0.8 + 0.05
  out["jax"] = jax_io.get_samples(
      jc, lambda x: x * 0.8 + 0.05, lambda **k: 1 / 0, 0, 3,
      str(tmp_path / "jax"), temperature=0.9)
  got = torch_io.get_samples(tc, inv_t, lambda **k: 1 / 0, 3,
                             str(tmp_path / "torch"), temperature=0.9)
  assert got["cached"] == "before" and sizes == [16, 4]
  np.testing.assert_array_equal(got["after"], out["jax"])


@pytest.mark.parametrize("n,c", [(64, 3), (10, 3), (9, 1)])
def test_png_grid_equals_jax_pixel_for_pixel(tmp_path, n, c):
  """The port's PNG grid (its own writer) decoded by PIL equals the JAX
  package's `save_png` (PIL) pixel for pixel: RGB and gray, a square
  number of images and not."""
  samples = np.random.default_rng(n).integers(0, 256, (n, 8, 6, c),
                                              dtype=np.uint8)
  jax_io.save_png(str(tmp_path / "jax.png"), samples)
  torch_io.save_png(str(tmp_path / "torch.png"), samples)
  a = np.asarray(Image.open(tmp_path / "jax.png"))
  b = np.asarray(Image.open(tmp_path / "torch.png"))
  assert a.shape == b.shape
  np.testing.assert_array_equal(a, b)
  np.testing.assert_array_equal(torch_io.image_grid(samples),
                                jax_io.image_grid(samples))


def test_sample_paths_match_jax(tmp_path):
  for leaves in ({}, {"sampling.pc_denoise": True,
                      "sampling.pc_denoise_time": 0.1},
                 {"sampling.more_step": True}):
    jc, tc = _cache_config("vesde", **leaves)
    assert torch_io.sample_paths(tc, str(tmp_path), 5) == \
        jax_io.sample_paths(jc, str(tmp_path), 5)


# ---------------------------------------------------------------------------
# the tiny nets: a whole VP PC round, and the sampling CLI's variants
# ---------------------------------------------------------------------------


def test_vp_pc_round_of_the_tiny_nets_matches_jax():
  """`vp/CIFAR10/indm_nll` with `sampling.method=pc` and its own
  predictor, `euler_maruyama`, with the Langevin corrector, through
  `run_lib.sample_round` with the tiny score net and flow (the port's
  seeded weights carried to the JAX models), JAX's draws replayed, as
  `tests/test_torch_ve.py` runs the VE round: within 1e-4 of the largest
  value."""
  overrides = {**tve.ROUND, "model.init_scale": 1.0,
               "sampling.method": "pc", "sampling.corrector": "langevin"}
  jc = jax_configs.get_config("vp/CIFAR10/indm_nll")
  tc = torch_configs.get_config("vp/CIFAR10/indm_nll")
  for k, v in overrides.items():
    tve._set(jc, k, v)
    tve._set(tc, k, v)
  assert tc.sampling.predictor == "euler_maruyama"
  tve.pc_round_matches_jax(jc, tc, tve.SHAPE)


def _sample_args(tmp_path, *extra):
  args = ["--config", tve.NAME, "--batch", "2", "--rounds", "1",
          "--workdir", str(tmp_path), "--device", "cpu"]
  for k, v in {**tve.ROUND, "model.num_scales": 3,
               "sampling.num_scales": 3}.items():
    args += ["--set", f"{k}={v}"]
  for item in extra:
    args += ["--set", item]
  return args


def test_sample_cli_runs_the_denoise_search_and_more_step(tmp_path, capsys):
  """`python -m indm_torch.sample --config ve/CIFAR10/indm --device cpu`:
  a plain round writes the step-(N-2) file; `--set sampling.pc_denoise=true
  --set sampling.need_sample=false` resumes from it (one denoise
  evaluation) and writes `samples_0_denoise_0.0.npz`, its before-flow file
  and `samples_0_denoise_0.0.png`; `sampling.more_step` resumes from the
  base before-flow file; a repeated call samples nothing."""
  torch_sample.main(_sample_args(tmp_path))
  ev = tmp_path / "eval"
  assert (ev / "samples_0.png").exists()
  rows = torch_sample.run(*_cli_config(tmp_path, "sampling.pc_denoise=true",
                                       "sampling.need_sample=false"))
  assert rows[0]["resumed"].endswith("samples_0_before_flow_for_search.npz")
  for name in ("samples_0_denoise_0.0.npz",
               "samples_0_before_flow_denoise_0.0.npz",
               "samples_0_denoise_0.0.png"):
    assert (ev / name).exists(), name
  png = np.asarray(Image.open(ev / "samples_0_denoise_0.0.png"))
  with np.load(ev / "samples_0_denoise_0.0.npz") as z:
    np.testing.assert_array_equal(png, torch_io.image_grid(z["samples"]))
  rows = torch_sample.run(*_cli_config(tmp_path, "sampling.more_step=true",
                                       "sampling.need_sample=false"))
  assert rows[0]["resumed"].endswith("samples_0_before_flow.npz")
  assert (ev / "samples_0_more_step.npz").exists()
  capsys.readouterr()
  torch_sample.main(_sample_args(tmp_path))
  assert "cached (after the flow)" in capsys.readouterr().out


def _cli_config(tmp_path, *extra):
  cfg = torch_configs.get_config(tve.NAME)
  args = _sample_args(tmp_path, *extra)
  for name, _, value in (args[i + 1].partition("=")
                         for i, a in enumerate(args) if a == "--set"):
    cfg.set_dotted(name, value)
  cfg.sampling.batch_size = 2
  return cfg, str(tmp_path), 2, 1, "cpu", lambda *a: None
