"""The port's likelihood path against the JAX package: the flow's
evaluation estimator (`IResBlock.eval_forward`, `flow_forward(train=False)`),
the Hutchinson divergence, the truncation residual, the NELBO and the ODE
bits/dim, each with the JAX draws replayed; the analytic-Gaussian cases of
`tests/test_sampling_likelihood.py`; and the GroupNorm wrappers' calls in
an NLL solve, which `chip_smoke.py` counts as kernel launches on the card.

Geometry: the tiny score net of `tests/test_torch_score.py` (init_scale 1,
so that the blocks matter) and the tiny wolf flow of
`tests/test_torch_train_step.py` (two scales of two blocks, width 8), with
the JAX weights carried over by `indm_torch.convert`. The ODE's bits/dim
takes the config's init_scale instead, as the JAX package's own test of
it does (`tests/test_likelihood_scipy_parity.py`): with random blocks at
init_scale 1 the probability-flow ODE amplifies rounding by orders of
magnitude from t = 1e-5 (2200 evaluations at rtol = atol = 1e-5, and two
solves on drifts equal to 1e-6 end 0.2 apart), so no tolerance on the
bits/dim would say anything there.
The JAX score net runs its GroupNorm through XLA (`model.fused_groupnorm`
off: the Pallas kernels' plain reference; the port's wrappers take their
plain versions on the CPU), which keeps its compiles inside a while loop
short; `tests/test_torch_group_norm.py` holds the kernels' plain versions
to the interpret-mode Pallas kernels. The JAX flow runs once, outside the
compiled functions, and its output goes in as constants.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_flows
import test_torch_train_step as tts
from indm_torch import configs as torch_configs
from indm_torch import convert
from indm_torch import likelihood as torch_lik
from indm_torch import sde as torch_sde
from indm_torch.configs import wolf_presets as torch_presets
from indm_torch.flows import flow_model as torch_fm
from indm_torch.flows import resflow as torch_resflow
from indm_torch.models import registry as torch_registry
from indm_torch.models.ncsnpp import NCSNpp
from indm_torch.ops import group_norm as gn
from indm_tpu import configs as jax_configs
from indm_tpu import likelihood as jax_lik
from indm_tpu import sde as jax_sde
from indm_tpu.configs import wolf_presets as jax_presets
from indm_tpu.flows import flow_model as jax_fm
from indm_tpu.models import create_model as jax_create_model
from indm_tpu.models import get_score_fn as jax_get_score_fn
from torch_threads import one_torch_thread  # noqa: F401

TINY = {"data.image_size": 8, "model.nf": 8, "model.num_res_blocks": 1,
        "model.ch_mult": (1, 1), "model.attn_resolutions": (4,),
        "model.init_scale": 1.0, "model.fused_groupnorm": True,
        "flow.nblocks": "2-2", "flow.intermediate_dim": 8,
        "flow.model_config": "tiny-train"}
B = 4
SHAPE = (B, 8, 8, 3)
# float32 convs and sums in another order through both nets
TOL = 1e-5
# the ODE's bits/dim: two RK45 solves with the same controller on drifts
# equal to rounding; the JAX package's own test of its solver holds 2e-3
# (`tests/test_likelihood_scipy_parity.py:124`)
BPD_RTOL = 1e-4


def _nchw(a):
  return torch.from_numpy(np.ascontiguousarray(
      np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
  return t.detach().permute(0, 2, 3, 1).numpy()


def _rademacher(rng, shape):
  return jax.random.randint(rng, shape, 0, 2).astype(jnp.float32) * 2 - 1.0


def _residual_noise(rng, shape):
  r1, r2 = jax.random.split(rng)
  return torch_lik.ResidualNoise(_nchw(jax.random.normal(r1, shape)),
                                 _nchw(jax.random.normal(r2, shape)))


def likelihood_noise(rng, shape):
  """The draws of JAX's `likelihood_fn(rng, ...)`."""
  _, eps_rng, pert_rng, res_rng = jax.random.split(rng, 4)
  return torch_lik.LikelihoodNoise(
      _nchw(_rademacher(eps_rng, shape)),
      _nchw(jax.random.normal(pert_rng, shape)),
      _residual_noise(res_rng, shape))


def elbo_noise(rng, shape):
  """The draws of JAX's `elbo_fn(rng, ...)`."""
  _, t_rng, z_rng, h_rng, lp_rng, res_rng = jax.random.split(rng, 6)
  return torch_lik.ElboNoise(
      torch.from_numpy(np.array(jax.random.uniform(t_rng, (shape[0],)))),
      _nchw(jax.random.normal(z_rng, shape)),
      _nchw(_rademacher(h_rng, shape)),
      _nchw(jax.random.normal(lp_rng, shape)),
      _residual_noise(res_rng, shape))


@pytest.fixture(scope="module")
def s():
  yield from setup()


def setup(**overrides):
  """Both packages' tiny score net (TINY with `overrides`) and flow with
  the same weights, their SDEs and score functions, a batch and the JAX
  eval-mode flow; a generator that unregisters the tiny wolf preset when
  resumed."""
  jax_presets.PRESETS["tiny-train"] = tts.TINY_WOLF
  torch_presets.PRESETS["tiny-train"] = tts.TINY_WOLF
  jc = jax_configs.get_config("vp/CIFAR10/indm_nll")
  tc = torch_configs.get_config("vp/CIFAR10/indm_nll")
  for k, v in {**TINY, **overrides}.items():
    tts._set(jc, k, v)
    tts._set(tc, k, v)
  jc.model.fused_groupnorm = False
  module, variables = jax_create_model(jc, jax.random.PRNGKey(0))
  fm = jax_fm.create_flow_model(jc)
  f_params, f_buffers = fm.init(jax.random.PRNGKey(1))
  # BatchNorm statistics away from their initial 0 and 1
  stats = jax.tree_util.tree_map(
      lambda a: np.asarray(a) + 0.1 * np.random.default_rng(2).random(
          a.shape).astype(np.float32), f_buffers["batch_stats"])
  f_buffers = {"batch_stats": stats}
  score = NCSNpp(tc)
  score.load_state_dict(convert.score_state_dict_from_jax(
      tts._np(variables["params"]), tc), strict=True)
  flow = torch_fm.FlowModel(tc)
  flow.load_state_dict(convert.flow_state_dict_from_jax(
      tts._np(f_params), tc, tts._np(stats)), strict=True)
  score.eval().requires_grad_(False)
  flow.eval().requires_grad_(False)
  jsde, tsde = jax_sde.get_sde(jc), torch_sde.get_sde(tc)
  batch = np.random.default_rng(4).uniform(-1, 1, SHAPE).astype(np.float32)
  z, ld = jax.jit(lambda x: jax_fm.flow_forward(
      jc, fm, f_params, f_buffers, x, train=False)[:2])(jnp.asarray(batch))
  yield dict(
      jc=jc, tc=tc, fm=fm, f_params=f_params, f_buffers=f_buffers,
      score=score, flow=flow, jsde=jsde, tsde=tsde, batch=batch,
      jscore=jax_get_score_fn(jc, jsde, module, variables, train=False,
                              continuous=True),
      tscore=torch_registry.get_score_fn(tc, tsde, score,
                                         differentiable=True),
      jflow=(np.asarray(z), np.asarray(ld)))
  jax_presets.PRESETS.pop("tiny-train", None)
  torch_presets.PRESETS.pop("tiny-train", None)


def port_ff(s, shape=SHAPE):
  """The port's eval-mode flow on JAX's draws of `flow_forward(rng=None)`
  (its PRNGKey(0))."""
  noise = tts.replay_flow_noise(s["fm"], s["f_params"], s["f_buffers"],
                                jax.random.PRNGKey(0), shape)
  return lambda x: torch_fm.flow_forward(s["tc"], s["flow"], x, train=False,
                                         noise=noise)


def jax_flow(s):
  """JAX's eval-mode flow of the fixture's batch, as constants."""
  z, ld = s["jflow"]
  return lambda x: (jnp.asarray(z), jnp.asarray(ld))


def _close(got, want, tol=TOL, err_msg=""):
  np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                             atol=tol, err_msg=err_msg)


# ---- the flow's evaluation estimator ----

def test_flow_forward_eval_matches_jax(s):
  """`flow_forward(train=False)`: z and log|det| - KL against JAX's with
  its draws replayed: the encoder's BatchNorm on its running statistics,
  every block's n + 20 term estimator. And with no noise given, the same
  draws in every call."""
  z_j, ld_j = s["jflow"]
  x = _nchw(s["batch"])
  z_t, ld_t = port_ff(s)(x)
  _close(_nhwc(z_t), z_j, err_msg="z")
  _close(ld_t.numpy(), ld_j, err_msg="logdet")
  assert not z_t.requires_grad and not ld_t.requires_grad
  a = torch_fm.flow_forward(s["tc"], s["flow"], x, train=False)
  b = torch_fm.flow_forward(s["tc"], s["flow"], x, train=False)
  assert all(torch.equal(p, q) for p, q in zip(a, b))
  assert not s["flow"].training


def test_block_eval_estimator_matches_jax_and_exact():
  """One iResBlock's evaluation log-det: against JAX's `_logdetgrad(
  train=False)` on the same (vareps, n) at 1e-5, and its mean over six
  draws against `exact_logdet` at the tolerance of
  `tests/test_flows.py:53`."""
  block, params = test_flows.small_block()
  port = torch_resflow.IResBlock(2, 8)
  port.load_state_dict(convert._iresblock(
      port, tts._np(params)), strict=True)
  x = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (3, 4, 4, 2))) \
      * 0.3
  exact = np.asarray(block.exact_logdet(params, jnp.asarray(x)))
  rng = np.random.default_rng(10)
  vals = []
  for _ in range(6):
    vareps = rng.normal(size=x.shape).astype(np.float32)
    n = int(rng.poisson(2.0))
    g_j, ld_j = block._logdetgrad(params, jnp.asarray(x), None, None,
                                  train=False,
                                  noise=(jnp.asarray(vareps),
                                         jnp.asarray(n, jnp.int32)))
    y_t, ld_t = port.eval_forward(_nchw(x), None, _nchw(vareps), n)
    _close(_nhwc(y_t), x + np.asarray(g_j), err_msg="y")
    _close(ld_t.numpy(), ld_j, err_msg=f"logdet n={n}")
    vals.append(ld_t.numpy())
  np.testing.assert_allclose(np.mean(vals, axis=0), exact, atol=0.06)


def test_eval_estimator_ignores_logdet_unroll(s):
  """The JAX package's fixed unroll truncates the training estimator only:
  the evaluation estimator runs its n + 20 terms either way."""
  x = _nchw(s["batch"])
  noise = tts.replay_flow_noise(s["fm"], s["f_params"], s["f_buffers"],
                                jax.random.PRNGKey(0), SHAPE)
  for b in s["flow"].resflow.blocks():
    b.unroll_terms = 4
  try:
    got = torch_fm.flow_forward(s["tc"], s["flow"], x, train=False,
                                noise=noise)
  finally:
    for b in s["flow"].resflow.blocks():
      b.unroll_terms = 0
  want = port_ff(s)(x)
  assert all(torch.equal(p, q) for p, q in zip(got, want))


# ---- divergence, residual, NELBO, ODE bits/dim ----

def test_div_fn_matches_jax(s):
  """The Hutchinson divergence of the probability-flow drift through the
  score net (kernel 2's VJP on the card) on the same Rademacher draw."""
  eps = _rademacher(jax.random.PRNGKey(7), SHAPE)
  t = 0.3 * jnp.ones((B,))
  jdrift = lambda x, tt: s["jsde"].reverse(s["jscore"], True).sde(x, tt)[0]
  tdrift = lambda x, tt: s["tsde"].reverse(s["tscore"], True).sde(x, tt)[0]
  want = jax.jit(jax_lik.get_div_fn(jdrift))(jnp.asarray(s["batch"]), t,
                                            eps)
  got = torch_lik.get_div_fn(tdrift)(_nchw(s["batch"]),
                                     torch.full((B,), 0.3), _nchw(eps))
  _close(got.numpy(), want)


def test_residual_matches_jax(s):
  for variance in ("scoreflow", "ddpm"):
    rng = jax.random.PRNGKey(8)
    want = jax.jit(jax_lik.get_likelihood_residual_fn(
        s["jc"], s["jsde"], s["jscore"], variance=variance,
        eps_bpd=1e-4))(rng, jnp.asarray(s["batch"]))
    got = torch_lik.get_likelihood_residual_fn(
        s["tc"], s["tsde"], s["tscore"], variance=variance, eps_bpd=1e-4)(
            _nchw(s["batch"]), noise=_residual_noise(rng, SHAPE))
    _close(got.numpy(), want, err_msg=variance)


def test_elbo_matches_jax(s):
  """The NELBO and its residual form through the flow's evaluation
  estimator, on JAX's draws."""
  rng = jax.random.PRNGKey(9)
  nelbo_j, res_j = jax.jit(lambda r, d: jax_lik.get_elbo_fn(
      s["jc"], s["jsde"], lambda x: (x + 1.0) / 2.0)(
          r, s["jscore"], jax_flow(s), d))(rng, jnp.asarray(s["batch"]))
  nelbo_t, res_t = torch_lik.get_elbo_fn(
      s["tc"], s["tsde"], lambda x: (x + 1.0) / 2.0)(
          s["tscore"], port_ff(s), _nchw(s["batch"]),
          noise=elbo_noise(rng, SHAPE))
  _close(nelbo_t.numpy(), nelbo_j, err_msg="nelbo")
  _close(res_t.numpy(), res_j, err_msg="nelbo_residual")


@pytest.fixture(scope="module")
def s_ode():
  yield from setup(**{"model.init_scale": 0.0})


def test_likelihood_bpd_matches_jax(s_ode):
  """The ODE's bits/dim through the flow and with the residual, at the
  configs' rtol = atol = 1e-5, on JAX's draws: the same number of function
  evaluations, the bits/dim within BPD_RTOL and the latent within 1e-5."""
  s = s_ode
  rng = jax.random.PRNGKey(11)
  lfn = jax_lik.get_likelihood_fn(s["jc"], s["jsde"], lambda x: x)
  bpd_j, z_j, nfe_j = jax.jit(
      lambda r, d: lfn(r, s["jscore"], jax_flow(s), d, residual=True,
                       eps_bpd=1e-5))(rng, jnp.asarray(s["batch"]))
  bpd_t, z_t, nfe_t = torch_lik.get_likelihood_fn(
      s["tc"], s["tsde"], lambda x: x)(
          s["tscore"], port_ff(s), _nchw(s["batch"]), residual=True,
          eps_bpd=1e-5, noise=likelihood_noise(rng, SHAPE))
  assert nfe_t == int(nfe_j)
  np.testing.assert_allclose(bpd_t.numpy(), np.asarray(bpd_j),
                             rtol=BPD_RTOL)
  _close(_nhwc(z_t), z_j, err_msg="z")


def test_nll_calls_the_group_norm_wrappers_as_counted(s_ode, monkeypatch):
  """In an NLL solve every function evaluation runs the score net forward
  once with autograd (each GroupNorm through `GroupNormAct`, kernel 1) and
  its VJP once (kernel 2), and the residual reads the score once more
  (kernel 1): the wrappers are called G * (nfe + 1) and G * nfe times for
  G GroupNorm layers, the counts `chip_smoke.py` holds the card's launches
  to (95 per evaluation at full width)."""
  calls = {"fwd": 0, "bwd": 0}
  fwd, bwd = gn.group_norm_act, gn.group_norm_act_backward

  def count(name, fn):
    def wrapper(*a, **k):
      calls[name] += 1
      return fn(*a, **k)
    return wrapper

  monkeypatch.setattr(gn, "group_norm_act", count("fwd", fwd))
  monkeypatch.setattr(gn, "group_norm_act_backward", count("bwd", bwd))
  s = s_ode
  layers = sum(type(m).__name__ == "GroupNorm" for m in s["score"].modules())
  _, _, nfe = torch_lik.get_likelihood_fn(
      s["tc"], s["tsde"], lambda x: x, rtol=1e-3, atol=1e-3)(
          s["tscore"], None, _nchw(s["batch"]),
          generator=torch.Generator().manual_seed(0))
  assert layers > 0 and nfe > 6
  assert calls == {"fwd": layers * (nfe + 1), "bwd": layers * nfe}


# ---- the analytic Gaussian (`tests/test_sampling_likelihood.py:141-175`) --

@pytest.fixture(scope="module")
def gauss():
  c = torch_configs.get_config("vp/CIFAR10/indm_nll")
  c.flow.model = "identity"
  c.data.image_size = 4
  return c, torch_sde.get_sde(c)


def exact_score(x, t):
  return -x


def test_ode_likelihood_matches_analytic_gaussian(gauss):
  """With the exact score of N(0, I) data the drift is 0: the bits/dim is
  the prior's, and z the input."""
  cfg, sde = gauss
  data = torch.from_numpy(np.random.default_rng(4).normal(
      size=(8, 3, 4, 4)).astype(np.float32))
  bpd, z, nfe = torch_lik.get_likelihood_fn(cfg, sde, lambda x: (x + 1) / 2)(
      exact_score, None, data, residual=False, eps_bpd=1e-5,
      generator=torch.Generator().manual_seed(0))
  analytic = -sde.prior_logp(data).numpy() / 48 / np.log(2) + 7.0
  np.testing.assert_allclose(bpd.numpy(), analytic, rtol=1e-3)
  np.testing.assert_allclose(z.numpy(), data.numpy(), atol=1e-3)


def test_elbo_matches_analytic_gaussian(gauss):
  """The single-sample NELBO of N(0, I) data, averaged over eight draws,
  within 0.15 bits of 0.5 log2(2 pi e) + 7."""
  cfg, sde = gauss
  data = torch.from_numpy(np.random.default_rng(5).normal(
      size=(128, 3, 4, 4)).astype(np.float32))
  elbo_fn = torch_lik.get_elbo_fn(cfg, sde, lambda x: (x + 1) / 2)
  vals = [elbo_fn(exact_score, None, data,
                  generator=torch.Generator().manual_seed(k))[0].mean()
          for k in range(8)]
  want = 0.5 * np.log2(2 * np.pi * np.e) + 7.0
  assert abs(float(np.mean(vals)) - want) < 0.15
