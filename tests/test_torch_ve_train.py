"""The port's VE training slice (`ve/CIFAR10/indm`) against the JAX package:
VESDE's importance sampling, kernel 9's backward (`Upfirdn2dFn`, the
adjoint of up/pad/FIR/down) and one joint `step_nll` of the VE net and the
flow.

The backward is held against `jax.grad` of the oracle `upfirdn2d_native`
at the VE net's four call patterns, with the forward test's tolerance
(atol 1e-5). The step runs at the tiny VE geometry of
`tests/test_torch_ve.py` (16x16 images, nf 16, one res block, ch_mult
(1, 2), attention at 8x8, `model.init_scale = 1.0`) with the tiny wolf
preset and a 2-2 flow of width 8, `model.dropout = 0` (threefry masks
cannot be replayed), every draw of the JAX step replayed, at the
tolerances of `tests/test_torch_train_step.py`. Kernel 9's plain version
and its plain backward run on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train_step as tts
from indm_torch import configs as torch_configs
from indm_torch import convert
from indm_torch import joint as torch_joint
from indm_torch import sde as torch_sde
from indm_torch.configs import wolf_presets as torch_presets
from indm_torch.flows import flow_model as torch_fm
from indm_torch.models.ncsnpp import NCSNpp
from indm_torch.ops import upfirdn2d as fir
from indm_tpu import configs as jax_configs
from indm_tpu import joint as jax_joint
from indm_tpu import ops as jax_ops
from indm_tpu import sde as jax_sde
from indm_tpu import state as jax_state
from indm_tpu.configs import wolf_presets as jax_presets
from indm_tpu.flows import flow_model as jax_fm
from indm_tpu.models import create_model as jax_create_model
from torch_threads import one_torch_thread  # noqa: F401

NAME = "ve/CIFAR10/indm"
TINY = {"data.image_size": 16, "model.nf": 16, "model.num_res_blocks": 1,
        "model.ch_mult": (1, 2), "model.attn_resolutions": (8,),
        "model.init_scale": 1.0, "model.dropout": 0.0,
        "training.batch_size": 4, "flow.nblocks": "2-2",
        "flow.intermediate_dim": 8, "flow.model_config": "tiny-train"}
B = 4
SHAPE = (B, 16, 16, 3)
FIR_ATOL = 1e-5


def configs(overrides=TINY):
  jc = jax_configs.get_config(NAME)
  tc = torch_configs.get_config(NAME)
  for k, v in overrides.items():
    tts._set(jc, k, v)
    tts._set(tc, k, v)
  return jc, tc


# ---- VESDE ----

def test_vesde_importance_sampling_matches_jax():
  """antiderivative, normalizing_constant and get_diffusion_time (both
  branches, the uniform replayed) at rtol 1e-6; Z detached as
  `stop_gradient` leaves it, t differentiable in t_min."""
  jc, tc = configs({})
  js, ts = jax_sde.get_sde(jc), torch_sde.get_sde(tc)
  for t in (1e-5, 1e-3, 0.37, 1.0):
    np.testing.assert_allclose(ts.antiderivative(t).numpy(),
                               np.asarray(js.antiderivative(t)), rtol=1e-6)
    np.testing.assert_allclose(ts.normalizing_constant(t).numpy(),
                               np.asarray(js.normalizing_constant(t)),
                               rtol=1e-6, atol=1e-6)
  rng = jax.random.PRNGKey(3)
  u = torch.from_numpy(np.array(jax.random.uniform(rng, (B,))))
  for t_min in (1e-5, 0.02):
    for importance in (True, False):
      tj, zj = js.get_diffusion_time(rng, B, jnp.float32(t_min), importance)
      tt, zt = ts.get_diffusion_time(B, torch.tensor(t_min), importance,
                                     device="cpu", u=u)
      np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-6)
      np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-6)
  t_min = torch.tensor(1e-3, requires_grad=True)
  t, z_norm = ts.get_diffusion_time(B, t_min, True, device="cpu", u=u)
  assert t.requires_grad and not z_norm.requires_grad
  assert bool((t >= t_min).all() and (t <= 1.0).all())


# ---- kernel 9's backward ----

# the VE net's calls: (NCHW input, up, down, pad, gain) and their adjoints'
# (up, down, pad)
PATTERNS = {
    "upsample_2d": (((2, 4, 8, 8), 2, 1, (2, 1), 4.0), (1, 2, (1, 1))),
    "downsample_2d": (((2, 4, 8, 8), 1, 2, (1, 1), 1.0), (2, 1, (2, 1))),
    "conv_downsample_2d": (((2, 3, 8, 8), 1, 1, (2, 2), 1.0),
                           (1, 1, (1, 1))),
    "upsample_conv_2d": (((2, 4, 17, 17), 1, 1, (1, 1), 4.0),
                         (1, 1, (2, 2))),
}


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_upfirdn2d_backward_matches_jax_grad(name):
  """`Upfirdn2dFn` on the CPU (the plain version both ways): its adjoint's
  (up, down, pads) those of the table, the forward and the input gradient
  against `upfirdn2d_native` and its `jax.vjp`, atol 1e-5."""
  (shape, up, down, pad, gain), want_adjoint = PATTERNS[name]
  k = jax_ops.setup_kernel([1, 3, 3, 1]) * np.float32(gain)
  rng = np.random.default_rng(11)
  x = rng.normal(size=shape).astype(np.float32)
  h = shape[2]
  oh = fir.out_size(h, 4, up, down, pad)
  dy = rng.normal(size=(shape[0], shape[1], oh, oh)).astype(np.float32)
  assert (down, up, fir.adjoint_pads(h, oh, 4, up, down, pad)) == \
      want_adjoint

  def native(v):
    return jax_ops.upfirdn2d_native(v, jnp.asarray(k), up, up, down, down,
                                    pad[0], pad[1], pad[0], pad[1])

  y_j, vjp = jax.vjp(native, jnp.asarray(x.transpose(0, 2, 3, 1)))
  (dx_j,) = vjp(jnp.asarray(dy.transpose(0, 2, 3, 1)))
  xt = torch.from_numpy(x).requires_grad_(True)
  before = (fir.launches, fir.bwd_launches)
  y = fir.Upfirdn2dFn.apply(xt, k, up, down, pad)
  assert type(y.grad_fn).__name__ == "Upfirdn2dFnBackward"
  y.backward(torch.from_numpy(dy))
  assert (fir.launches, fir.bwd_launches) == before  # the CPU: no kernel
  np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(),
                             np.asarray(y_j), atol=FIR_ATOL)
  np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(),
                             np.asarray(dx_j), atol=FIR_ATOL)


def test_kernel_route_keeps_the_graph_or_raises(monkeypatch):
  """R1 without a card. The kernel route, `upfirdn2d` on a CUDA tensor that
  needs a gradient, goes through `Upfirdn2dFn` (no longer a bare launch
  into a fresh tensor without a grad_fn), and only a call that needs none
  (no requires_grad, or under no_grad) launches bare. The Function, whose
  guard the card takes too, returns an output with its backward, and
  raises where the kernel cannot take the adjoint (a pad past the taps)."""
  k = fir.setup_kernel([1, 3, 3, 1])
  calls = []

  class Recorder:
    @staticmethod
    def apply(*args):
      calls.append(("function", args[2:]))
      return "graph"

  def bare(*args):
    calls.append(("bare", args[2:]))
    return "no graph"

  class CudaTensor:
    device = torch.device("cuda")

    def __init__(self, requires_grad):
      self.requires_grad = requires_grad

  monkeypatch.setattr(fir, "Upfirdn2dFn", Recorder)
  monkeypatch.setattr(fir, "_forward", bare)
  assert fir.upfirdn2d(CudaTensor(True), k, 2, 1, (2, 1)) == "graph"
  assert fir.upfirdn2d(CudaTensor(False), k, 2, 1, (2, 1)) == "no graph"
  with torch.no_grad():
    assert fir.upfirdn2d(CudaTensor(True), k, 2, 1, (2, 1)) == "no graph"
  assert calls == [("function", (2, 1, (2, 1))), ("bare", (2, 1, (2, 1))),
                   ("bare", (2, 1, (2, 1)))]
  monkeypatch.undo()

  x = torch.randn(2, 3, 8, 8, requires_grad=True)
  y = fir.Upfirdn2dFn.apply(x, k, 1, 1, (2, 2))
  assert y.requires_grad and type(y.grad_fn).__name__ == \
      "Upfirdn2dFnBackward"
  assert fir.adjoint_pads(8, 9, 4, 1, 1, (5, 0))[0] < 0
  with pytest.raises(ValueError, match="adjoint"):
    fir.Upfirdn2dFn.apply(x, k, 1, 1, (5, 0))


# ---- one VE step_nll ----

@pytest.fixture(scope="module")
def step():
  """The JAX VE step at the tiny geometry, run once with optimizers that
  record the gradients, and the port's joint losses on its batch and
  replayed draws, with their gradients."""
  jax_presets.PRESETS["tiny-train"] = tts.TINY_WOLF
  torch_presets.PRESETS["tiny-train"] = tts.TINY_WOLF
  jc, tc = configs()
  module, variables = jax_create_model(jc, jax.random.PRNGKey(0))
  buffers = {k: v for k, v in variables.items() if k != "params"}
  fm = jax_fm.create_flow_model(jc)
  f_params, f_buffers = fm.init(jax.random.PRNGKey(1))
  opt = tts._record_grads()
  ss = jax_state.init_train_state(jc, variables["params"], buffers, opt,
                                  jax.random.PRNGKey(2))
  fs = jax_state.init_train_state(jc, f_params, f_buffers, opt,
                                  jax.random.PRNGKey(3))
  step_fn = jax_joint.make_joint_step_fn(jc, jax_sde.get_sde(jc), module, fm,
                                         opt, opt, train=True)
  batch = np.random.default_rng(4).uniform(0, 1, SHAPE).astype(np.float32)
  (ss2, fs2), metrics = jax.jit(step_fn)((ss, fs), jnp.asarray(batch))

  score = NCSNpp(tc)
  score.load_state_dict(convert.score_state_dict_from_jax(
      tts._np(variables["params"]), tc, tts._np(buffers["buffers"])),
                        strict=True)
  flow = torch_fm.FlowModel(tc)
  flow.load_state_dict(convert.flow_state_dict_from_jax(
      tts._np(f_params), tc, tts._np(f_buffers["batch_stats"])), strict=True)
  score.train()
  flow.train()
  noise = tts.replay_step_noise(fm, f_params, f_buffers, ss.rng, SHAPE)
  losses = torch_joint.make_joint_losses(tc, torch_sde.get_sde(tc), score,
                                         flow)
  aux = losses(tts._nchw(batch), noise)
  aux["losses"].mean().backward()
  yield dict(tc=tc, score=score, flow=flow, aux=aux, ss2=ss2, fs2=fs2,
             buffers=tts._np(buffers["buffers"]),
             metrics=[np.asarray(m) for m in metrics])
  jax_presets.PRESETS.pop("tiny-train", None)
  torch_presets.PRESETS.pop("tiny-train", None)


def test_ve_step_losses_match(step):
  """Per-example losses and their three terms to 1e-4; losses = score +
  flow + logp."""
  aux = step["aux"]
  for name, want in zip(torch_joint.METRICS, step["metrics"]):
    np.testing.assert_allclose(aux[name].detach().numpy(), want, rtol=1e-4,
                               atol=1e-4, err_msg=name)
  np.testing.assert_allclose(
      aux["losses"].detach().numpy(),
      (aux["losses_score"] + aux["losses_flow"]
       + aux["losses_logp"]).detach().numpy(), rtol=1e-5)


def test_ve_step_gradients_match(step):
  """Both nets' gradients before any update, at rtol 1e-4 and atol 1e-5
  in units of each tensor's largest value (floored at 1): the Fourier
  features of log sigma reach about 1e3 rad, where one float32 step of the
  argument moves a feature by about 1e-4, and the first dense layer's
  gradient, some 1e2 at its largest, carries that into its smallest
  elements (as `tests/test_torch_ve.py` holds the VE score to its scale).
  The Fourier projection's W stays a buffer with no gradient."""
  tc = step["tc"]
  g_score = convert.score_state_dict_from_jax(
      tts._np(step["ss2"].opt_state["g"]), tc, step["buffers"])
  g_flow = convert.flow_state_dict_from_jax(
      tts._np(step["fs2"].opt_state["g"]), tc)
  n = 0
  for model, want in ((step["score"], g_score), (step["flow"], g_flow)):
    named = dict(model.named_parameters())
    assert set(named) <= set(want)
    for name, p in named.items():
      assert p.grad is not None, name
      w = want[name].numpy()
      scale = max(np.abs(w).max(), 1.0)
      np.testing.assert_allclose(p.grad.numpy() / scale, w / scale,
                                 rtol=1e-4, atol=1e-5, err_msg=name)
      n += 1
  assert n > 100
  assert "all_modules.0.W" not in dict(step["score"].named_parameters())
  assert "all_modules.0.W" in dict(step["score"].named_buffers())
