"""The joint steps with two micro-batches (`optim.num_micro_batch=2`)
against the JAX package's (`indm_tpu/joint.py:41-43, 105-137, 172-222`).

At the tiny geometry of `test_torch_train_step.py`, the batch of 4 cut
into two contiguous chunks of 2: `step_nll` and `step_fid` with st off
and on, every draw of each chunk replayed from the JAX step's keys (one
`StepNoise` a chunk). Compared: the per-example losses (to 1e-4), both
nets' summed gradients (in `step_fid` with st on the score net's
g <- c_k g + h_k chunk by chunk), and the encoder's BatchNorm statistics
carried from the first chunk to the second (1e-5), at the limits of the
one-chunk tests (`test_torch_train_step.py`, `test_torch_fid_step.py`)
but for the gradients' absolute floor: rtol 1e-4 and the larger of 1e-5
and 1e-4 of the tensor's largest value. The importance-sampled diffusion
time of one of these draws (u = 0.6658) is one float32 step apart between
XLA's and torch's exp and log (0.46483670 against 0.46483675); times 999
into the time embedding's sin and cos, that moves the first dense layer's
gradient by 1.9e-5 of its largest 0.23. The JAX package's own test of
these steps holds loss means to 2e-3 and the updated parameters' norms to
5e-4 (`tests/test_golden.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_fid_step as tfs
import test_torch_train_step as tts
from indm_torch import configs as torch_configs
from indm_torch import convert
from indm_torch import ema as torch_ema
from indm_torch import joint as torch_joint
from indm_torch import optim as torch_optim
from indm_torch import sde as torch_sde
from indm_torch.configs import wolf_presets as torch_presets
from indm_tpu import configs as jax_configs
from indm_tpu import joint as jax_joint
from indm_tpu import sde as jax_sde
from indm_tpu import state as jax_state
from indm_tpu.configs import wolf_presets as jax_presets
from indm_tpu.flows import flow_model as jax_fm
from indm_tpu.models import create_model as jax_create_model
from torch_threads import one_torch_thread  # noqa: F401

B, MICRO = 4, 2
_np, _nchw = tts._np, tts._nchw


def setup(name, st):
  """The JAX step of `name` (NLL or FID variant) with two micro-batches at
  the tiny geometry, run once with optimizers that record their gradients
  (the FID variant's also apply AdamW, so that its second phase sees the
  updated flow)."""
  jax_presets.PRESETS["tiny-train"] = tts.TINY_WOLF
  torch_presets.PRESETS["tiny-train"] = tts.TINY_WOLF
  jc, tc = jax_configs.get_config(name), torch_configs.get_config(name)
  for k, v in {**tts.TINY, "training.st": st,
               "optim.num_micro_batch": MICRO}.items():
    tts._set(jc, k, v)
    tts._set(tc, k, v)
  module, variables = jax_create_model(jc, jax.random.PRNGKey(0))
  fm = jax_fm.create_flow_model(jc)
  f_params, f_buffers = fm.init(jax.random.PRNGKey(1))
  fid = not jc.training.likelihood_weighting
  if fid:
    s_opt = tfs._record_then(jax_state.make_optimizer(jc))
    f_opt = tfs._record_then(jax_state.make_optimizer(jc, lr=jc.flow.lr))
  else:
    s_opt = f_opt = tts._record_grads()
  ss = jax_state.init_train_state(jc, variables["params"], {}, s_opt,
                                  jax.random.PRNGKey(2))
  fs = jax_state.init_train_state(jc, f_params, f_buffers, f_opt,
                                  jax.random.PRNGKey(3))
  step = jax_joint.make_joint_step_fn(jc, jax_sde.get_sde(jc), module, fm,
                                      s_opt, f_opt, train=True)
  batch = np.random.default_rng(4).uniform(-1, 1, (B, 8, 8, 3)).astype(
      np.float32)
  (ss2, fs2), metrics = jax.jit(step)((ss, fs), jnp.asarray(batch))
  return dict(jc=jc, tc=tc, module=module, variables=variables, fm=fm,
              f_params=f_params, f_buffers=f_buffers, ss=ss, ss2=ss2,
              fs2=fs2, metrics=[np.asarray(m) for m in metrics], batch=batch,
              st=st, fid=fid)


def replay(s):
  """One `StepNoise` per micro-batch from the JAX step's keys: phase 1's
  key split per chunk (`joint.py:115-116, 173-175`), each split again as
  the one-chunk step splits it; phase 2's likewise."""
  keys = jax.random.split(s["ss"].rng, 3 if s["fid"] else 2)
  shape = (B // MICRO,) + s["batch"].shape[1:]
  out = []
  for k, k2 in zip(jax.random.split(keys[1], MICRO),
                   jax.random.split(keys[2], MICRO) if s["fid"]
                   else [None] * MICRO):
    r_flow, r_score, r_logp = jax.random.split(k, 3)
    _, rng_t, rng_z, _, _, _ = jax.random.split(r_score, 6)
    phase2 = None
    if k2 is not None:
      enc_eps = None
      if not s["st"]:
        rf, k2 = jax.random.split(k2)
        enc_eps = tts.replay_flow_noise(s["fm"], s["f_params"],
                                        s["f_buffers"], rf, shape).enc_eps
      rng_tmin2, rng_t2, rng_z2, _, _, _ = jax.random.split(k2, 6)
      phase2 = torch_joint.Phase2Noise(
          torch.from_numpy(np.array(jax.random.uniform(rng_t2, shape[:1]))),
          _nchw(jax.random.normal(rng_z2, shape)), enc_eps,
          torch.from_numpy(np.array(jax.random.uniform(rng_tmin2, ()))))
    out.append(torch_joint.StepNoise(
        tts.replay_flow_noise(s["fm"], s["f_params"], s["f_buffers"], r_flow,
                              shape),
        torch.from_numpy(np.array(jax.random.uniform(rng_t, shape[:1]))),
        _nchw(jax.random.normal(rng_z, shape)),
        _nchw(jax.random.normal(r_logp, shape)), phase2))
  return out


def run_port(s):
  """The port's step on the JAX batch and replayed draws; in the FID
  variant JAX's updated flow is carried across before phase 2."""
  tc = s["tc"]
  score, flow = tts.port_models(s)
  opts = [tfs.Recorder(torch_optim.make_optimizer(tc, score.parameters())),
          tfs.Recorder(torch_optim.make_optimizer(tc, flow.parameters(),
                                                  lr=tc.flow.lr))]
  emas = [torch_ema.EMA(o.params, r) for o, r in
          zip(opts, (tc.model.ema_rate, tc.flow.ema_rate))]
  step = torch_joint.make_joint_step_fn(tc, torch_sde.get_sde(tc), score,
                                        flow, *opts, *emas)
  kw = {}
  if s["fid"]:
    carried = convert.flow_state_dict_from_jax(_np(s["fs2"].params), tc)

    def phase_hook(name):
      with torch.no_grad():
        for k, p in flow.named_parameters():
          p.copy_(carried[k])

    kw["phase_hook"] = phase_hook
  metrics = step(_nchw(s["batch"]), replay(s), **kw)
  return dict(score=score, flow=flow, opts=opts, metrics=metrics)


CASES = {"nll": ("vp/CIFAR10/indm_nll", False),
         "fid_st_off": ("vp/CIFAR10/indm_fid", False),
         "fid_st_on": ("vp/CIFAR10/indm_fid", True)}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
  s = setup(*CASES[request.param])
  yield s, run_port(s)
  jax_presets.PRESETS.pop("tiny-train", None)
  torch_presets.PRESETS.pop("tiny-train", None)


def test_micro_batch_losses_match(pair):
  s, port = pair
  for name, got, want in zip(torch_joint.METRICS, port["metrics"],
                             s["metrics"]):
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4,
                               err_msg=name)


@pytest.mark.parametrize("net", ["score", "flow"])
def test_micro_batch_gradients_match(pair, net):
  s, port = pair
  tc = s["tc"]
  g = (s["ss2"] if net == "score" else s["fs2"]).opt_state["g"]
  to_sd = (convert.score_state_dict_from_jax if net == "score"
           else convert.flow_state_dict_from_jax)
  want = to_sd(_np(g), tc)
  model, opt = ((port["score"], port["opts"][0]) if net == "score"
                else (port["flow"], port["opts"][1]))
  names = [k for k, _ in model.named_parameters()]
  assert len(names) == len(opt.g) > 20
  for k, got in zip(names, opt.g):
    assert got is not None, k
    big = float(np.abs(want[k].numpy()).max())
    np.testing.assert_allclose(got.numpy(), want[k].numpy(), rtol=1e-4,
                               atol=max(1e-5, 1e-4 * big), err_msg=k)


def test_micro_batch_batchnorm_buffers_carried(pair):
  """The encoder's statistics after both chunks (and, in the FID variant
  with st off, both chunks' recomputes): the JAX scan's carry."""
  s, port = pair
  want = convert.flow_state_dict_from_jax(
      _np(s["fs2"].params), s["tc"], _np(s["fs2"].buffers["batch_stats"]))
  got = port["flow"].state_dict()
  names = [k for k in want if k.endswith(("running_mean", "running_var"))]
  assert names
  for k in names:
    np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5,
                               atol=1e-5, err_msg=k)
