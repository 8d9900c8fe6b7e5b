"""The FID variant in the port against the JAX package: the config
`vp/CIFAR10/indm_fid`, the one-step reconstruction term of the loss, the
flow's forward without the log-det, and `step_fid` (`indm_tpu/joint.py:
169-235`) with soft truncation off (the config's case: z recomputed by the
updated flow) and on (phase 1's z reused, const_adj).

The step runs at the tiny geometry of `tests/test_torch_train_step.py`
(the same preset, widths and `model.dropout = 0`; the slice's kernels on,
the JAX side's Pallas in interpret mode) with every JAX draw replayed,
phase 2's included. The JAX step runs once per variant with optimizers
that keep the gradients they are given in their state and then apply
AdamW, so that each net's gradients are compared as the phase that uses
them made them, and the parameters after the whole step. Phase 2 reads the
flow after its AdamW step: the first AdamW step is lr x sign(g) wherever
|g| is well above eps, so a gradient a rounding away from zero can move a
flow weight by 2 x lr (2e-3) and carry that into z. So the port takes
JAX's updated flow parameters before its phase 2 (the step's
`phase_hook`), and its own update is compared apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_train_step as tts
from indm_torch import configs as torch_configs
from indm_torch import convert
from indm_torch import ema as torch_ema
from indm_torch import joint as torch_joint
from indm_torch import losses as torch_losses
from indm_torch import optim as torch_optim
from indm_torch import sde as torch_sde
from indm_torch.configs import wolf_presets as torch_presets
from indm_torch.flows import flow_model as torch_fm
from indm_tpu import configs as jax_configs
from indm_tpu import joint as jax_joint
from indm_tpu import losses as jax_losses
from indm_tpu import sde as jax_sde
from indm_tpu import state as jax_state
from indm_tpu.configs import wolf_presets as jax_presets
from indm_tpu.flows import flow_model as jax_fm
from indm_tpu.models import create_model as jax_create_model
from torch_threads import one_torch_thread  # noqa: F401

NAME = "vp/CIFAR10/indm_fid"
B = tts.B
_np, _nchw, _nhwc = tts._np, tts._nchw, tts._nhwc


def test_fid_config_leaves_equal_jax_config():
  """Every leaf of the port's `indm_fid` has JAX's name and value; it
  differs from `indm_nll` in the two weightings only."""
  ours = torch_configs.get_config(NAME)
  theirs = dict(jax_configs.get_config(NAME).to_dict())
  theirs.pop("jax")

  def flat(d, prefix=""):
    for k, v in d.items():
      if isinstance(v, dict):
        yield from flat(v, f"{prefix}{k}.")
      else:
        yield f"{prefix}{k}", v

  assert dict(ours.leaves()) == dict(flat(theirs))
  nll = dict(torch_configs.get_config("vp/CIFAR10/indm_nll").leaves())
  assert {k for k, v in ours.leaves() if nll[k] != v} == {
      "training.likelihood_weighting", "training.importance_sampling"}


def _record_then(opt):
  """`opt` (an optax transformation) that also keeps the gradients it was
  given in its state under "g"."""

  def init(params):
    return {"g": jax.tree_util.tree_map(jnp.zeros_like, params),
            "opt": opt.init(params)}

  def update(grads, state, params=None):
    updates, inner = opt.update(grads, state["opt"], params)
    return updates, {"g": grads, "opt": inner}

  return optax.GradientTransformation(init, update)


class Recorder:
  """The port's optimizer with the gradients of its step kept."""

  def __init__(self, opt):
    self.opt, self.params, self.g = opt, opt.params, None

  def zero_grad(self):
    self.opt.zero_grad()

  def step(self):
    self.g = [None if p.grad is None else p.grad.clone() for p in self.params]
    self.opt.step()


def fid_setup(st):
  """The JAX `step_fid` at the tiny geometry (training.st = `st`), run
  once with recording AdamW optimizers; yields a dict."""
  jax_presets.PRESETS["tiny-train"] = tts.TINY_WOLF
  torch_presets.PRESETS["tiny-train"] = tts.TINY_WOLF
  jc, tc = jax_configs.get_config(NAME), torch_configs.get_config(NAME)
  for k, v in {**tts.TINY, "training.st": st}.items():
    tts._set(jc, k, v)
    tts._set(tc, k, v)
  module, variables = jax_create_model(jc, jax.random.PRNGKey(0))
  fm = jax_fm.create_flow_model(jc)
  f_params, f_buffers = fm.init(jax.random.PRNGKey(1))
  s_opt = _record_then(jax_state.make_optimizer(jc))
  f_opt = _record_then(jax_state.make_optimizer(jc, lr=jc.flow.lr))
  ss = jax_state.init_train_state(jc, variables["params"], {}, s_opt,
                                  jax.random.PRNGKey(2))
  fs = jax_state.init_train_state(jc, f_params, f_buffers, f_opt,
                                  jax.random.PRNGKey(3))
  step = jax_joint.make_joint_step_fn(jc, jax_sde.get_sde(jc), module, fm,
                                      s_opt, f_opt, train=True)
  assert step.__name__ == "step_fid"
  batch = np.random.default_rng(4).uniform(-1, 1, (B, 8, 8, 3)).astype(
      np.float32)
  (ss2, fs2), metrics = jax.jit(step)((ss, fs), jnp.asarray(batch))
  yield dict(jc=jc, tc=tc, module=module, variables=variables, fm=fm,
             f_params=f_params, f_buffers=f_buffers, ss=ss, ss2=ss2,
             fs2=fs2, metrics=[np.asarray(m) for m in metrics], batch=batch,
             st=st)
  jax_presets.PRESETS.pop("tiny-train", None)
  torch_presets.PRESETS.pop("tiny-train", None)


def replay_fid_noise(s):
  """Every draw of one JAX `step_fid` from the score state's key
  (`joint.py:171-174`): phase 1's as `step_nll`'s, phase 2's from its own
  key (split again into the recompute's and the loss's with st off)."""
  _, step_rng, phase2_rng = jax.random.split(s["ss"].rng, 3)
  shape = s["batch"].shape
  (k,) = jax.random.split(step_rng, 1)
  r_flow, r_score, r_logp = jax.random.split(k, 3)
  _, rng_t, rng_z, _, _, _ = jax.random.split(r_score, 6)
  (k2,) = jax.random.split(phase2_rng, 1)
  enc_eps = None
  if not s["st"]:
    rf, k2 = jax.random.split(k2)
    enc_eps = tts.replay_flow_noise(s["fm"], s["f_params"], s["f_buffers"],
                                    rf, shape).enc_eps
  rng_tmin2, rng_t2, rng_z2, _, _, _ = jax.random.split(k2, 6)
  phase2 = torch_joint.Phase2Noise(
      torch.from_numpy(np.array(jax.random.uniform(rng_t2, (B,)))),
      _nchw(jax.random.normal(rng_z2, shape)), enc_eps,
      torch.from_numpy(np.array(jax.random.uniform(rng_tmin2, ()))))
  return torch_joint.StepNoise(
      tts.replay_flow_noise(s["fm"], s["f_params"], s["f_buffers"], r_flow,
                            shape),
      torch.from_numpy(np.array(jax.random.uniform(rng_t, (B,)))),
      _nchw(jax.random.normal(rng_z, shape)),
      _nchw(jax.random.normal(r_logp, shape)), phase2)


def run_port_step(s):
  """The port's `step_fid` on the JAX step's batch and replayed draws,
  with JAX's updated flow carried across before phase 2."""
  tc = s["tc"]
  score, flow = tts.port_models(s)
  opts = [Recorder(torch_optim.make_optimizer(tc, score.parameters())),
          Recorder(torch_optim.make_optimizer(tc, flow.parameters(),
                                              lr=tc.flow.lr))]
  emas = [torch_ema.EMA(o.params, r) for o, r in
          zip(opts, (tc.model.ema_rate, tc.flow.ema_rate))]
  step = torch_joint.make_joint_step_fn(tc, torch_sde.get_sde(tc), score,
                                        flow, *opts, *emas)
  assert step.__name__ == "step_fid"
  carried = convert.flow_state_dict_from_jax(_np(s["fs2"].params), tc)
  own = {}

  def phase_hook(name):
    assert name == "phase2"
    own.update({k: p.detach().clone() for k, p in flow.named_parameters()})
    with torch.no_grad():
      for k, p in flow.named_parameters():
        p.copy_(carried[k])

  metrics = step(_nchw(s["batch"]), replay_fid_noise(s),
                 phase_hook=phase_hook)
  return dict(score=score, flow=flow, opts=opts, emas=emas, own=own,
              metrics=metrics)


@pytest.fixture(scope="module", params=[False, True], ids=["st_off", "st_on"])
def pair(request):
  gen = fid_setup(request.param)
  s = next(gen)
  yield s, run_port_step(s)
  next(gen, None)


def test_step_fid_metrics_match(pair):
  """losses, losses_flow and losses_logp (phase 1) and losses_score (phase
  2) per example, to rtol and atol 1e-4."""
  s, port = pair
  for name, got, want in zip(torch_joint.METRICS, port["metrics"],
                             s["metrics"]):
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4,
                               err_msg=name)
  phase1 = s["metrics"][1:]
  assert not np.allclose(s["metrics"][0], sum(phase1), rtol=1e-3)


def _grads(s, port, net):
  """(name, the port's gradient, JAX's) for every parameter of `net`."""
  tc = s["tc"]
  if net == "score":
    want = convert.score_state_dict_from_jax(
        _np(s["ss2"].opt_state["g"]), tc)
    model, opt = port["score"], port["opts"][0]
  else:
    want = convert.flow_state_dict_from_jax(_np(s["fs2"].opt_state["g"]),
                                            tc)
    model, opt = port["flow"], port["opts"][1]
  names = [k for k, _ in model.named_parameters()]
  assert len(names) == len(opt.g) > 20
  for k, g in zip(names, opt.g):
    yield k, g, want[k]


@pytest.mark.parametrize("net", ["score", "flow"])
def test_step_fid_gradients_match(pair, net):
  """The flow's gradients of phase 1 and the score net's of phase 2 (with
  st on, const_adj x phase 1's + phase 2's), to rtol 1e-4, atol 1e-5."""
  s, port = pair
  for k, got, want in _grads(s, port, net):
    assert got is not None, k
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5, err_msg=k)


def test_step_fid_batchnorm_buffers_match(pair):
  """The encoder's running statistics after both phases (with st off the
  recompute moves them a second time), to 1e-5."""
  s, port = pair
  want = convert.flow_state_dict_from_jax(
      _np(s["fs2"].params), s["tc"], _np(s["fs2"].buffers["batch_stats"]))
  got = port["flow"].state_dict()
  names = [k for k in want if k.endswith(("running_mean", "running_var"))]
  assert names
  for k in names:
    np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5,
                               atol=1e-5, err_msg=k)


# the parameters and EMAs after the whole step. AdamW's first step moves
# an element by lr x g / (|g| + 1e-8) (bias-corrected): lr wherever |g| is
# well above 1e-8, whatever the gradient's rounding. Where the float32
# gradients of both sides are a rounding away from zero (|g| ~ 1e-9, the
# attention's key biases and the like), the step is a fraction of lr of
# either sign: for the score net (lr 2e-4) at most 2e-4 x 1e-9 / (1e-9 +
# 1e-8) x 2, 4e-5 apart; the tolerance is 1e-4.
STEP_ATOL = 1e-4


def test_step_fid_parameters_and_emas_match(pair):
  """Both nets' parameters and EMAs after the whole step: the score net
  and its EMA, the flow's own update (before JAX's was carried across) and
  the flow's EMA, to rtol 1e-4 and atol STEP_ATOL."""
  s, port = pair
  tc = s["tc"]
  checks = [
      (convert.score_state_dict_from_jax(_np(s["ss2"].params), tc),
       dict(port["score"].named_parameters())),
      (convert.score_state_dict_from_jax(_np(s["ss2"].ema_params), tc),
       dict(zip([k for k, _ in port["score"].named_parameters()],
                port["emas"][0].shadow))),
      (convert.flow_state_dict_from_jax(_np(s["fs2"].params), tc),
       port["own"]),
      (convert.flow_state_dict_from_jax(_np(s["fs2"].ema_params), tc),
       dict(zip([k for k, _ in port["flow"].named_parameters()],
                port["emas"][1].shadow)))]
  for want, got in checks:
    assert len(got) > 20
    for k, v in got.items():
      np.testing.assert_allclose(v.detach().numpy(), want[k].numpy(),
                                 rtol=1e-4, atol=STEP_ATOL, err_msg=k)
  assert port["emas"][0].num_updates == port["emas"][1].num_updates == 1


@pytest.mark.parametrize("st,importance_sampling", [
    (False, False), (True, True), (True, False)])
def test_reconstruction_term_matches(st, importance_sampling):
  """`loss_fn(..., recon_loss=True)` against JAX's with its draws replayed
  (t_min's uniform, u_t, z, z_e), an analytic score function on both sides
  (as `tests/test_torch_losses.py` holds the loss): per-example losses to
  rtol 1e-5, atol 1e-5; without the term the losses differ."""
  jc, tc = jax_configs.get_config(NAME), torch_configs.get_config(NAME)
  js, ts = jax_sde.get_sde(jc), torch_sde.get_sde(tc)
  batch = np.random.default_rng(7).uniform(-1, 1, (B, 8, 8, 3)).astype(
      np.float32)
  rng = jax.random.PRNGKey(8)

  def score_j(x, t, rng=None):
    return -x * (1.0 + t[:, None, None, None]) + 0.1 * jnp.sin(x)

  def score_t(x, t, generator=None):
    return -x * (1.0 + t[:, None, None, None]) + 0.1 * torch.sin(x)

  want = jax_losses.get_sde_loss_fn(jc, js, True)(
      score_j, jnp.asarray(batch), rng, st=st, recon_loss=True,
      importance_sampling=importance_sampling)
  rng_tmin, rng_t, rng_z, _, rng_rz, _ = jax.random.split(rng, 6)
  draws = dict(u_t=torch.from_numpy(np.array(jax.random.uniform(rng_t,
                                                                (B,)))),
               z=_nchw(jax.random.normal(rng_z, batch.shape)),
               u_tmin=torch.from_numpy(np.array(jax.random.uniform(
                   rng_tmin, ()))),
               importance_sampling=importance_sampling)
  loss = torch_losses.get_sde_loss_fn(tc, ts)
  got = loss(score_t, _nchw(batch), st=st, recon_loss=True,
             z_e=_nchw(jax.random.normal(rng_rz, batch.shape)), **draws)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                             atol=1e-5)
  plain = loss(score_t, _nchw(batch), st=st, recon_loss=False, **draws)
  assert not np.allclose(plain.numpy(), got.numpy(), rtol=1e-3)


def test_reconstruction_dropout_draws_from_its_generator():
  """The reconstruction term's score evaluation takes its dropout masks
  from `recon_generator`: the term is a function of that seed alone."""
  tc = torch_configs.get_config(NAME)
  ts = torch_sde.get_sde(tc)
  loss = torch_losses.get_sde_loss_fn(tc, ts)
  batch = torch.randn(2, 3, 4, 4, generator=torch.Generator().manual_seed(0))
  u_t, z = torch.rand(2), torch.randn(2, 3, 4, 4)

  def score(x, t, generator=None):
    return -x * torch.rand(x.shape, generator=generator)

  def run(seed):
    return loss(score, batch, generator=torch.Generator().manual_seed(1),
                u_t=u_t, z=z, recon_loss=True, z_e=z,
                recon_generator=torch.Generator().manual_seed(seed))

  assert torch.equal(run(2), run(2)) and not torch.equal(run(2), run(3))


def test_flow_forward_without_logdet_matches(pair):
  """`flow_forward(train=True, eval_logdet=False)` on the JAX draw of the
  encoder's eps: z to 1e-5, no log-det, the BatchNorm statistics moved as
  JAX's, under no_grad as well."""
  s, _ = pair
  rng = jax.random.PRNGKey(9)
  z_j, ld_j, nb = jax_fm.flow_forward(
      s["jc"], s["fm"], s["f_params"], s["f_buffers"],
      jnp.asarray(s["batch"]), rng=rng, train=True, eval_logdet=False)
  assert ld_j is None
  eps = tts.replay_flow_noise(s["fm"], s["f_params"], s["f_buffers"], rng,
                              s["batch"].shape).enc_eps
  _, flow = tts.port_models(s)
  with torch.no_grad():
    z_t, ld_t = torch_fm.flow_forward(s["tc"], flow, _nchw(s["batch"]),
                                      train=True, eval_logdet=False,
                                      noise=torch_fm.FlowNoise(eps, []))
  assert ld_t is None
  np.testing.assert_allclose(_nhwc(z_t), np.asarray(z_j), rtol=1e-5,
                             atol=1e-5)
  want = convert.flow_state_dict_from_jax(_np(s["f_params"]), s["tc"],
                                          _np(nb["batch_stats"]))
  got = flow.state_dict()
  for k in want:
    if k.endswith(("running_mean", "running_var")):
      np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5,
                                 atol=1e-5, err_msg=k)


def test_step_fid_refuses_micro_batches(pair):
  """Micro-batches are taken (`test_torch_joint_micro.py` holds them
  against JAX); what is refused is a batch that optim.num_micro_batch does
  not divide, whose reshape fails in the JAX step too
  (`indm_tpu/joint.py:41-43`), and noise for another count of chunks."""
  s, _ = pair
  tc = torch_configs.get_config(NAME)
  for k, v in {**tts.TINY, "training.st": s["st"],
               "optim.num_micro_batch": 2}.items():
    tts._set(tc, k, v)
  score, flow = tts.port_models(dict(s, tc=tc))
  opts = [torch_optim.make_optimizer(tc, m.parameters()) for m in (score,
                                                                   flow)]
  step = torch_joint.make_joint_step_fn(
      tc, torch_sde.get_sde(tc), score, flow, *opts,
      *(torch_ema.EMA(o.params, 0.999) for o in opts))
  batch = _nchw(s["batch"])
  with pytest.raises(ValueError, match="num_micro_batch"):
    step(batch[:3])
  with pytest.raises(ValueError, match="micro-batches"):
    step(batch, [replay_fid_noise(s)])
