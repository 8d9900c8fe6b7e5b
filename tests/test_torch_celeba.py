"""CelebA at 64x64 in the port against the JAX package: the three CelebA
configs, the squeezed flow (`flow.squeeze`: the image squeezed to 12
channels before the resflow and back after it), the discriminator on 12
planes, kernel 7's plain version at 48 channels, the three training steps,
and the image-folder loader with its PIL-free PNG reader and bicubic
resize.

Geometry: 16x16 images, squeezed to 8x8x12 and then 4x4x48 between the
flow's two scales (nblocks "1-1", width 8); NCSN++ at nf 8, one res block,
ch_mult (1, 1), attention at 8x8; a tiny wolf preset in the shape of the
imagenet-64 one (the encoder's 12 input planes). `model.dropout = 0`
(threefry masks cannot be replayed), `model.init_scale = 1.0`. Every draw
of a JAX step is replayed in the port; the tolerances are those of
`tests/test_torch_ve_train.py` and `tests/test_torch_fid_step.py`. Each
JAX step is built once per module.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_fid_step as tfs
import test_torch_neumann as tn
import test_torch_train_step as tts
from indm_torch import configs as torch_configs
from indm_torch import convert
from indm_torch import data as torch_data
from indm_torch import image_io
from indm_torch import joint as torch_joint
from indm_torch import optim as torch_optim
from indm_torch import ema as torch_ema
from indm_torch import sde as torch_sde
from indm_torch.configs import wolf_presets as torch_presets
from indm_torch.flows import flow_model as torch_fm
from indm_torch.flows import wolf as torch_wolf
from indm_torch.models.ncsnpp import NCSNpp
from indm_torch.ops import fused_block as torch_fused_block
from indm_torch.ops import neumann
from indm_tpu import configs as jax_configs
from indm_tpu import data as jax_data
from indm_tpu import joint as jax_joint
from indm_tpu import sde as jax_sde
from indm_tpu import state as jax_state
from indm_tpu.configs import wolf_presets as jax_presets
from indm_tpu.flows import flow_model as jax_fm
from indm_tpu.flows.resflow import _poisson_rcdf_table
from indm_tpu.models import create_model as jax_create_model
from indm_tpu.ops import neumann_pallas
from torch_threads import one_torch_thread  # noqa: F401

NLL, FID, VE = "vp/CELEBA/indm_nll", "vp/CELEBA/indm_fid", "ve/CELEBA/indm"
PRESET = "tiny-celeba"
# the imagenet-64 preset's shape: the encoder takes the squeezed image's
# 12 planes
TINY_WOLF = copy.deepcopy(tts.TINY_WOLF)
TINY_WOLF["discriminator"]["encoder"]["in_planes"] = 12
TINY = {"data.image_size": 16, "model.nf": 8, "model.num_res_blocks": 1,
        "model.ch_mult": (1, 1), "model.attn_resolutions": (8,),
        "model.init_scale": 1.0, "model.dropout": 0.0,
        "training.batch_size": 4, "flow.nblocks": "1-1",
        "flow.intermediate_dim": 8, "flow.model_config": PRESET}
B = 4
SHAPE = (B, 16, 16, 3)
SQUEEZED = (B, 8, 8, 12)
_np, _nchw, _nhwc = tts._np, tts._nchw, tts._nhwc


@pytest.fixture(scope="module", autouse=True)
def tiny_preset():
  jax_presets.PRESETS[PRESET] = TINY_WOLF
  torch_presets.PRESETS[PRESET] = TINY_WOLF
  yield
  jax_presets.PRESETS.pop(PRESET, None)
  torch_presets.PRESETS.pop(PRESET, None)


def configs(name, overrides=TINY):
  jc, tc = jax_configs.get_config(name), torch_configs.get_config(name)
  for k, v in overrides.items():
    tts._set(jc, k, v)
    tts._set(tc, k, v)
  return jc, tc


# ---- configs ----

@pytest.mark.parametrize("name", [NLL, FID, VE])
def test_celeba_config_is_64x64_with_the_squeeze(name):
  """What CelebA changes against CIFAR-10: 64x64 images, the squeeze, the
  imagenet-64 preset, snr 0.15, sigma_max 90, the evaluation's first
  checkpoint and test count, and nothing else."""
  ours = dict(torch_configs.get_config(name).leaves())
  cifar = dict(torch_configs.get_config(name.replace("CELEBA", "CIFAR10"))
               .leaves())
  changed = {k: ours[k] for k in ours if ours[k] != cifar[k]}
  assert changed == {
      "data.dataset": "CELEBA", "data.image_size": 64, "flow.squeeze": True,
      "flow.image_size": 64, "flow.dataset": "celeba",
      "flow.model_config": "flow_models/wolf/wolf_configs/imagenet/64x64/"
                           "glow/resflow-gaussian-uni.json",
      "sampling.snr": 0.15, "model.sigma_max": 90.0, "eval.begin_ckpt": 1,
      "eval.num_test_data": 19962}


def test_full_width_discriminator_takes_12_planes():
  """The imagenet-64 preset at CelebA's full geometry: the encoder's first
  conv takes the squeezed image's 12 planes on 32x32, the head 8 x 4 x 4
  = 128 features, as the JSON says."""
  cfg = torch_configs.get_config(NLL)
  params = torch_presets.load_wolf_params(cfg.flow.model_config)
  enc = params["discriminator"]["encoder"]
  disc = torch_wolf.make_discriminator(params, 32, 12, device="meta")
  conv = next(m for m in disc.modules() if isinstance(m, torch.nn.Conv2d))
  assert conv.in_channels == enc["in_planes"] == 12
  assert disc.fc.linear.weight_v.shape[1] == params["discriminator"][
      "in_dim"] == 128


# ---- the squeezed flow ----

@pytest.fixture(scope="module")
def flows():
  jc, tc = configs(NLL)
  fm = jax_fm.create_flow_model(jc)
  params, buffers = fm.init(jax.random.PRNGKey(1))
  model = torch_fm.FlowModel(tc)
  model.load_state_dict(convert.flow_state_dict_from_jax(
      _np(params), tc, _np(buffers["batch_stats"])), strict=True)
  assert model.squeeze and fm.squeeze
  return jc, tc, fm, params, buffers, model


def test_discriminator_at_12_planes_matches(flows):
  """The encoder and the head on the squeezed 8x8x12 input: (mu, logvar)
  of the Gaussian posterior to 1e-5, and the KL of `sampling_and_kl` with
  its eps replayed to 1e-4."""
  jc, tc, fm, params, buffers, model = flows
  x = np.random.default_rng(3).uniform(-1, 1, SQUEEZED).astype(np.float32)
  vars_ = {"params": params["disc"], "batch_stats": buffers["batch_stats"]}
  mu_j, logvar_j = fm.disc.apply(vars_, jnp.asarray(x), train=False)
  model.discriminator.eval()
  with torch.no_grad():
    mu_t, logvar_t = model.discriminator(_nchw(x))
  np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j).reshape(B, -1),
                             rtol=1e-5, atol=1e-5)
  np.testing.assert_allclose(logvar_t.numpy(),
                             np.asarray(logvar_j).reshape(B, -1),
                             rtol=1e-5, atol=1e-5)
  rng = jax.random.PRNGKey(5)
  h_j, kl_j = fm.disc.apply(vars_, jnp.asarray(x), train=False,
                            method=fm.disc.sampling_and_KL,
                            rngs={"sample": rng})
  eps = fm.disc.apply(
      vars_, method=lambda m: jax.random.normal(m.make_rng("sample"),
                                                (B, 1, m.dim)),
      rngs={"sample": rng})
  with torch.no_grad():
    h_t, kl_t = model.discriminator.sampling_and_kl(
        _nchw(x), torch.from_numpy(np.array(eps).reshape(B, -1)))
  np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j).reshape(B, -1),
                             rtol=1e-5, atol=1e-5)
  np.testing.assert_allclose(kl_t.numpy(), np.asarray(kl_j).reshape(B),
                             rtol=1e-4, atol=1e-4)


def test_squeezed_flow_forward_and_logdet_match(flows):
  """`flow_forward(train=True)` on 16x16x3 images: the squeeze before the
  resflow and the unsqueeze after it (z to 1e-5, back at 16x16x3), log|det|
  - KL to 1e-4, with every draw replayed at the squeezed shapes: 8x8x12,
  then 4x4x48."""
  jc, tc, fm, params, buffers, model = flows
  x = np.random.default_rng(4).uniform(-1, 1, SHAPE).astype(np.float32)
  rng = jax.random.PRNGKey(8)
  z_j, ld_j, _ = jax_fm.flow_forward(jc, fm, params, buffers, jnp.asarray(x),
                                     rng=rng, train=True)
  noise = tts.replay_flow_noise(fm, params, buffers, rng, SQUEEZED)
  assert [tuple(v.shape) for v, _ in noise.blocks] == [(B, 12, 8, 8),
                                                       (B, 48, 4, 4)]
  model = copy.deepcopy(model).train()  # its BatchNorm statistics move
  z_t, ld_t = torch_fm.flow_forward(tc, model, _nchw(x), train=True,
                                    noise=noise)
  assert tuple(z_t.shape) == (B, 3, 16, 16)
  np.testing.assert_allclose(_nhwc(z_t), np.asarray(z_j), rtol=1e-5,
                             atol=1e-5)
  np.testing.assert_allclose(ld_t.detach().numpy(), np.asarray(ld_j),
                             rtol=1e-4, atol=1e-4)


def test_squeezed_flow_evaluation_estimator_matches(flows):
  """`flow_forward(train=False)` (the evaluation estimator, the encoder's
  BatchNorm on its running statistics) with JAX's draws of its
  PRNGKey(0) replayed at the squeezed shapes: z and log|det| - KL to
  1e-5."""
  jc, tc, fm, params, buffers, model = flows
  x = np.random.default_rng(6).uniform(-1, 1, SHAPE).astype(np.float32)
  z_j, ld_j, _ = jax_fm.flow_forward(jc, fm, params, buffers, jnp.asarray(x),
                                     train=False)
  noise = tts.replay_flow_noise(fm, params, buffers, jax.random.PRNGKey(0),
                                SQUEEZED)
  model.eval()
  z_t, ld_t = torch_fm.flow_forward(tc, model, _nchw(x), train=False,
                                    noise=noise)
  np.testing.assert_allclose(_nhwc(z_t), np.asarray(z_j), rtol=1e-5,
                             atol=1e-5)
  np.testing.assert_allclose(ld_t.numpy(), np.asarray(ld_j), rtol=1e-5,
                             atol=1e-5)


def test_squeezed_flow_inverse_matches(flows):
  """`flow_forward(reverse=True)`: the squeeze, the prior's h (its eps
  replayed), `bwdpass` and the unsqueeze, to 1e-4 (the prior's inverse is
  float64 in the port); the inverse undoes the forward to 1e-3."""
  jc, tc, fm, params, buffers, model = flows
  z = np.random.default_rng(5).normal(size=SHAPE).astype(np.float32)
  x_j, _, _ = jax_fm.flow_forward(jc, fm, params, buffers, jnp.asarray(z),
                                  rng=None, reverse=True)
  rng_h, _ = jax.random.split(jax.random.PRNGKey(0))
  eps = np.array(fm.disc.apply(
      {"params": params["disc"], "batch_stats": buffers["batch_stats"]}, B,
      method=lambda m, n: jax.random.normal(m.make_rng("sample"), (n, m.dim)),
      rngs={"sample": rng_h}))
  model.eval()
  x_t, _ = torch_fm.flow_forward(tc, model, _nchw(z), reverse=True,
                                 prior_eps=torch.from_numpy(eps))
  assert tuple(x_t.shape) == (B, 3, 16, 16)
  np.testing.assert_allclose(_nhwc(x_t), np.asarray(x_j), rtol=1e-4,
                             atol=1e-4)
  h = model.discriminator.sample_from_prior(B, epsilon=torch.from_numpy(eps))
  from indm_torch.flows.resflow import squeeze, unsqueeze
  with torch.no_grad():
    back, _ = model.resflow.fwdpass_plain(squeeze(x_t, 2), h), None
  np.testing.assert_allclose(unsqueeze(back, 2).numpy(), _nchw(z).numpy(),
                             atol=1e-3)


# ---- kernel 7's plain version at 48 channels ----

@pytest.mark.parametrize("n", [0, 2, 5])
@pytest.mark.parametrize("preact,cond", tn.CASES)
def test_chain_plain_at_48_channels_matches_ref(preact, cond, n):
  """CelebA's second flow scale: `chain_mats` and `neumann_chain_plain` at
  C = 48 on 4x4 against the JAX net's and `neumann_chain_ref` (rtol 1e-4,
  atol 1e-5, `test_torch_neumann.py`'s)."""
  nnet, params, block, x, h, eps = tn._setup(preact, cond, in_ch=48,
                                             idim=32, hw=4)
  hj = None if h is None else jnp.asarray(h)
  weights_t, dacts = nnet.chain_mats(params, jnp.asarray(x), h=hj)
  with torch.no_grad():
    wt_port, d_port = block.chain_mats(
        _nchw(x), None if h is None else torch.from_numpy(h))
  table = _poisson_rcdf_table(2.0, tn.OFFSET)
  acc_ref = neumann_pallas.neumann_chain_ref(
      jnp.asarray(eps), dacts, weights_t, jnp.asarray(n, jnp.int32),
      tn.OFFSET, jnp.asarray(table))
  neumann.reset_launches()
  acc = neumann.neumann_chain(_nchw(eps), d_port, wt_port, n, tn.OFFSET,
                              table)
  assert neumann.launches == 0 and tuple(acc.shape) == (4, 48, 4, 4)
  np.testing.assert_allclose(_nhwc(acc), np.asarray(acc_ref), rtol=1e-4,
                             atol=1e-5)


def test_kernels_off_the_path_name_48_channels_and_the_switch():
  """48 channels: kernel 7 takes them in float32 and in bfloat16 (the
  chain route under `flow.logdet_bf16` / `flow.mixed_precision`: the
  wrapper's checks pass); kernel 8 (INDM_FUSED_CHAIN=1), kernels 3-6
  (flow.fused_block) and kernel 10 refuse them with a message that names
  the count and the switch, as the JAX package's `fused_chain_ok` sends a
  48-channel block to kernel 7 and kernel 10 is a 3 <-> 512 benchmark. The
  flow sends such a block to the chain."""
  from indm_torch.ops import narrow_conv
  _, _, block, x, h, eps = tn._setup(True, True, in_ch=48, idim=40, hw=4)
  with torch.no_grad():
    wt, d = block.chain_mats(_nchw(x), torch.from_numpy(h))
    neumann._check(_nchw(eps), d, wt)  # float32: taken
    wt16, d16 = block.chain_mats(_nchw(x), torch.from_numpy(h),
                                 torch.bfloat16)
  neumann._check(_nchw(eps).bfloat16(), d16, wt16)  # bfloat16: taken
  with torch.no_grad():
    fwd, biases, weights_t, hp = neumann.fused_chain_inputs(
        block, torch.from_numpy(h))
  with pytest.raises(ValueError, match=r"48 channels.*fused_chain_ok"):
    neumann._check_fused(_nchw(x), _nchw(eps), fwd, biases, weights_t, hp)
  w0, w1, w2 = (c.normalized_weight().detach() for c in block.convs())
  b0, b1 = (c.bias.detach() for c in block.convs()[:2])
  with pytest.raises(ValueError, match=r"got 48.*flow.fused_block"):
    torch_fused_block._check(_nchw(x), w0, w1, w2, b0, b1, hp)
  with pytest.raises(ValueError, match=r"48 narrow channels"):
    narrow_conv._check(_nchw(x), torch.zeros(64, 48, 3, 3))
  assert not block.fused_ok()


# ---- PC sampling ----

def test_pc_round_at_celeba_matches_jax():
  """`ve/CELEBA/indm`'s PC round (snr 0.15, sigma_max 90) with the
  squeezed flow's inverse, 6 scales, JAX's draws replayed: the images
  before and after the flow and the step-(N-2) mean within 1e-4 of their
  largest magnitude (`test_torch_ve.pc_round_matches_jax`)."""
  import test_torch_ve as tve
  jc, tc = configs(VE, {**TINY, "model.num_scales": 6,
                        "sampling.num_scales": 6})
  assert tc.sampling.snr == 0.15 and tc.model.sigma_max == 90.0
  tve.pc_round_matches_jax(jc, tc, SHAPE)


# ---- the three training steps ----

def replay_step_noise(fm, f_params, f_buffers, score_rng):
  """Every draw of one JAX `step_nll` (`tts.replay_step_noise`), the flow's
  at the squeezed shapes."""
  _, step_rng = jax.random.split(score_rng)
  (k,) = jax.random.split(step_rng, 1)
  r_flow, r_score, r_logp = jax.random.split(k, 3)
  _, rng_t, rng_z, _, _, _ = jax.random.split(r_score, 6)
  return torch_joint.StepNoise(
      tts.replay_flow_noise(fm, f_params, f_buffers, r_flow, SQUEEZED),
      torch.from_numpy(np.array(jax.random.uniform(rng_t, (B,)))),
      _nchw(jax.random.normal(rng_z, SHAPE)),
      _nchw(jax.random.normal(r_logp, SHAPE)))


def replay_fid_noise(fm, f_params, f_buffers, score_rng):
  """Every draw of one JAX `step_fid` with st off
  (`tfs.replay_fid_noise`), the flow's at the squeezed shapes."""
  _, step_rng, phase2_rng = jax.random.split(score_rng, 3)
  (k2,) = jax.random.split(phase2_rng, 1)
  rf, k2 = jax.random.split(k2)
  enc_eps = tts.replay_flow_noise(fm, f_params, f_buffers, rf,
                                  SQUEEZED).enc_eps
  rng_tmin2, rng_t2, rng_z2, _, _, _ = jax.random.split(k2, 6)
  phase1 = replay_step_noise(fm, f_params, f_buffers, score_rng)
  return phase1._replace(phase2=torch_joint.Phase2Noise(
      torch.from_numpy(np.array(jax.random.uniform(rng_t2, (B,)))),
      _nchw(jax.random.normal(rng_z2, SHAPE)), enc_eps,
      torch.from_numpy(np.array(jax.random.uniform(rng_tmin2, ())))))


def jax_step(name, s_opt, f_opt):
  """The JAX step of `name` at the tiny geometry, run once: the states
  before and after, its metrics, the models and the batch."""
  jc, tc = configs(name)
  module, variables = jax_create_model(jc, jax.random.PRNGKey(0))
  buffers = {k: v for k, v in variables.items() if k != "params"}
  fm = jax_fm.create_flow_model(jc)
  f_params, f_buffers = fm.init(jax.random.PRNGKey(1))
  ss = jax_state.init_train_state(jc, variables["params"], buffers, s_opt,
                                  jax.random.PRNGKey(2))
  fs = jax_state.init_train_state(jc, f_params, f_buffers, f_opt,
                                  jax.random.PRNGKey(3))
  step = jax_joint.make_joint_step_fn(jc, jax_sde.get_sde(jc), module, fm,
                                      s_opt, f_opt, train=True)
  batch = np.random.default_rng(4).uniform(0, 1, SHAPE).astype(np.float32)
  if jc.data.centered:
    batch = batch * 2 - 1
  (ss2, fs2), metrics = jax.jit(step)((ss, fs), jnp.asarray(batch))
  score = NCSNpp(tc)
  score.load_state_dict(convert.score_state_dict_from_jax(
      _np(variables["params"]), tc,
      _np(buffers["buffers"]) if "buffers" in buffers else None),
                        strict=True)
  flow = torch_fm.FlowModel(tc)
  flow.load_state_dict(convert.flow_state_dict_from_jax(
      _np(f_params), tc, _np(f_buffers["batch_stats"])), strict=True)
  return dict(jc=jc, tc=tc, fm=fm, f_params=f_params, f_buffers=f_buffers,
              ss=ss, ss2=ss2, fs2=fs2, score=score.train(),
              flow=flow.train(), batch=batch,
              buffers=_np(buffers.get("buffers")),
              metrics=[np.asarray(m) for m in metrics])


class _XlaLog:
  """`torch` with `log` giving XLA's float32 bits (a 1-D tensor that needs
  no gradient: the VE net's log sigma), for the VE step below."""

  def __getattr__(self, name):
    return getattr(torch, name)

  @staticmethod
  def log(t):
    assert t.dim() == 1 and not t.requires_grad
    return torch.from_numpy(np.array(jnp.log(jnp.asarray(t.numpy()))))


def test_xla_log_is_the_one_off_by_a_bit():
  """Why the VE step takes XLA's log of sigma: on CelebA's range of sigma
  (0.01 to 90) XLA's float32 log misses the correctly rounded value in
  about 7 % of arguments, torch's in under 0.1 %; the VE net's Fourier
  features multiply log sigma by up to 2 pi |W| (some 1e3 rad at
  fourier_scale 16), so one ulp there moves a feature by about 1e-4 and
  the gradients fed by the time embedding by some 3e-5 of their scale,
  past the step's tolerance."""
  x = np.exp(np.random.default_rng(0).uniform(
      np.log(0.01), np.log(90.0), 20000)).astype(np.float32)
  exact = np.log(x.astype(np.float64)).astype(np.float32)
  ours = torch.log(torch.from_numpy(x)).numpy()
  theirs = np.asarray(jnp.log(jnp.asarray(x)))
  assert (ours != exact).mean() < 1e-3 < 0.03 < (theirs != exact).mean()
  assert np.abs(ours.view(np.int32) - theirs.view(np.int32)).max() <= 1


@pytest.fixture(scope="module", params=[NLL, VE])
def nll_step(request):
  """`step_nll` of the VP NLL and the VE config in JAX with gradient-
  recording optimizers, and the port's joint losses on its batch and
  draws, with their gradients. The VE net takes XLA's bits of log sigma
  (`test_xla_log_is_the_one_off_by_a_bit`), as it takes JAX's draws."""
  from indm_torch.models import ncsnpp
  opt = tts._record_grads()
  s = jax_step(request.param, opt, opt)
  noise = replay_step_noise(s["fm"], s["f_params"], s["f_buffers"],
                            s["ss"].rng)
  losses = torch_joint.make_joint_losses(s["tc"], torch_sde.get_sde(s["tc"]),
                                         s["score"], s["flow"])
  with pytest.MonkeyPatch.context() as mp:
    if request.param == VE:
      mp.setattr(ncsnpp, "torch", _XlaLog())
    s["aux"] = losses(_nchw(s["batch"]), noise)
    s["aux"]["losses"].mean().backward()
  return s


def test_step_nll_losses_match(nll_step):
  """Per-example losses and their three terms to 1e-4; losses = score +
  flow + logp."""
  aux = nll_step["aux"]
  for name, want in zip(torch_joint.METRICS, nll_step["metrics"]):
    np.testing.assert_allclose(aux[name].detach().numpy(), want, rtol=1e-4,
                               atol=1e-4, err_msg=name)
  np.testing.assert_allclose(
      aux["losses"].detach().numpy(),
      (aux["losses_score"] + aux["losses_flow"]
       + aux["losses_logp"]).detach().numpy(), rtol=1e-5)


def test_step_nll_gradients_match(nll_step):
  """Both nets' gradients before any update at rtol 1e-4 and atol 1e-5 in
  units of each tensor's largest value floored at 1 (the VE test's
  scaling; the VP net's gradients are under 1 in this geometry, so its
  test's unscaled tolerance holds as well)."""
  s = nll_step
  tc = s["tc"]
  g_score = convert.score_state_dict_from_jax(
      _np(s["ss2"].opt_state["g"]), tc, s["buffers"])
  g_flow = convert.flow_state_dict_from_jax(_np(s["fs2"].opt_state["g"]),
                                            tc)
  n = 0
  for model, want in ((s["score"], g_score), (s["flow"], g_flow)):
    named = dict(model.named_parameters())
    assert set(named) <= set(want)
    for name, p in named.items():
      assert p.grad is not None, name
      w = want[name].numpy()
      scale = max(np.abs(w).max(), 1.0)
      np.testing.assert_allclose(p.grad.numpy() / scale, w / scale,
                                 rtol=1e-4, atol=1e-5, err_msg=name)
      n += 1
  assert n > 50


@pytest.fixture(scope="module")
def fid_step():
  """`step_fid` of the FID config (st off, the config's case) in JAX with
  recording AdamW optimizers, and the port's step on its batch and draws,
  JAX's updated flow carried in before phase 2 (`tfs.run_port_step`)."""
  jc, _ = configs(FID)
  s = jax_step(FID, tfs._record_then(jax_state.make_optimizer(jc)),
               tfs._record_then(jax_state.make_optimizer(jc,
                                                         lr=jc.flow.lr)))
  tc, score, flow = s["tc"], s["score"], s["flow"]
  opts = [tfs.Recorder(torch_optim.make_optimizer(tc, score.parameters())),
          tfs.Recorder(torch_optim.make_optimizer(tc, flow.parameters(),
                                                  lr=tc.flow.lr))]
  emas = [torch_ema.EMA(o.params, r) for o, r in
          zip(opts, (tc.model.ema_rate, tc.flow.ema_rate))]
  step = torch_joint.make_joint_step_fn(tc, torch_sde.get_sde(tc), score,
                                        flow, *opts, *emas)
  assert step.__name__ == "step_fid"
  carried = convert.flow_state_dict_from_jax(_np(s["fs2"].params), tc)

  def phase_hook(name):
    with torch.no_grad():
      for k, p in flow.named_parameters():
        p.copy_(carried[k])

  s["port_metrics"] = step(_nchw(s["batch"]), replay_fid_noise(
      s["fm"], s["f_params"], s["f_buffers"], s["ss"].rng),
                           phase_hook=phase_hook)
  s["opts"] = opts
  return s


def test_step_fid_losses_match(fid_step):
  """losses, losses_flow and losses_logp (phase 1) and losses_score (phase
  2) per example, to rtol and atol 1e-4."""
  s = fid_step
  for name, got, want in zip(torch_joint.METRICS, s["port_metrics"],
                             s["metrics"]):
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4,
                               err_msg=name)


@pytest.mark.parametrize("net", ["score", "flow"])
def test_step_fid_gradients_match(fid_step, net):
  """The flow's gradients of phase 1 and the score net's of phase 2, to
  rtol 1e-4, atol 1e-5."""
  s = fid_step
  tc = s["tc"]
  state, model, opt = ((s["ss2"], s["score"], s["opts"][0]) if net == "score"
                       else (s["fs2"], s["flow"], s["opts"][1]))
  want = (convert.score_state_dict_from_jax if net == "score" else
          convert.flow_state_dict_from_jax)(_np(state.opt_state["g"]), tc)
  names = [k for k, _ in model.named_parameters()]
  assert len(names) == len(opt.g) > 20
  for k, g in zip(names, opt.g):
    assert g is not None, k
    np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-4,
                               atol=1e-5, err_msg=k)


# ---- image folders ----

def _celeba_folder(root, n_train=5, n_test=3, seed=0, split=True):
  """Seeded PNGs in CelebA's geometry (178 x 218) under `root/celeba/`:
  `train/` and `test/`, or one flat folder; smooth images (so that the
  resize's taps matter), one of each colour type the writer emits."""
  rng = np.random.default_rng(seed)
  base = os.path.join(root, "celeba")
  files = []
  for i in range(n_train + n_test):
    sub = ("train" if i < n_train else "test") if split else ""
    os.makedirs(os.path.join(base, sub), exist_ok=True)
    img = (np.cumsum(rng.normal(size=(218, 178, 3)), axis=1) * 12
           + rng.uniform(60, 200)).clip(0, 255).astype(np.uint8)
    ctype = (2, 0, 6, 4, 3)[i % 5]
    path = os.path.join(base, sub, f"{i:06d}.png")
    if ctype == 3:
      pal = rng.integers(0, 256, (256, 3), dtype=np.uint8)
      image_io.write_png(path, img[..., 0], 3, pal)
    else:
      n = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
      extra = rng.integers(0, 256, (218, 178, max(n - 3, 0) + (n == 2)),
                           dtype=np.uint8)
      pix = {0: img[..., :1], 2: img, 4: np.concatenate(
          [img[..., :1], extra[..., :1]], 2),
             6: np.concatenate([img, extra[..., :1]], 2)}[ctype]
      image_io.write_png(path, pix, ctype)
    files.append(path)
  return files


@pytest.mark.parametrize("split", [True, False], ids=["train_test", "flat"])
def test_image_folder_matches_jax_loader_bit_for_bit(tmp_path, split):
  """`data.load_arrays` on a seeded CelebA PNG folder against
  `indm_tpu.data._load_image_folder` (PIL's decode and bicubic resize):
  the same uint8 arrays, bit for bit, for both splits; the port writes
  the JAX package's `celeba_64.npz` cache and reads it back."""
  _celeba_folder(tmp_path / "ours", split=split)
  _celeba_folder(tmp_path / "theirs", split=split)
  jc, tc = configs(NLL, {"datadir": ""})
  jc.datadir = tc.datadir = str(tmp_path / "theirs")
  want = jax_data._load_image_folder(jc, str(tmp_path / "theirs"))
  tc.datadir = str(tmp_path / "ours")
  assert not torch_data.is_synthetic(tc)
  got = torch_data.load_arrays(tc)
  for g, w in zip(got, want):
    assert g.dtype == np.uint8 and g.shape[1:] == (64, 64, 3)
    np.testing.assert_array_equal(g, w)
  assert len(got[0]) == (5 if split else 7) and len(got[1]) == (3 if split
                                                                else 1)
  cache = tmp_path / "ours" / "celeba_64.npz"
  assert cache.exists()
  with np.load(cache) as z:
    np.testing.assert_array_equal(z["train"], got[0])
  again = torch_data.load_arrays(tc)  # from the cache
  np.testing.assert_array_equal(again[0], got[0])


def test_png_reader_matches_pil_on_every_colour_type(tmp_path):
  """`image_io.read_png` against PIL's `Image.open(...).convert("RGB")` on
  files of each colour type `write_png` emits (gray, RGB, palette,
  gray+alpha, RGBA), each row with one of the five filters."""
  from PIL import Image
  rng = np.random.default_rng(1)
  for ctype, n in ((0, 1), (2, 3), (3, 1), (4, 2), (6, 4)):
    img = rng.integers(0, 256, (23, 31, n), dtype=np.uint8)
    path = str(tmp_path / f"c{ctype}.png")
    image_io.write_png(path, img, ctype,
                       rng.integers(0, 256, (256, 3), dtype=np.uint8)
                       if ctype == 3 else None)
    with Image.open(path) as im:
      assert im.mode == {0: "L", 2: "RGB", 3: "P", 4: "LA", 6: "RGBA"}[ctype]
      want = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(image_io.read_png(path), want)


@pytest.mark.parametrize("hw,out", [((218, 178), (64, 64)),
                                    ((140, 140), (64, 64)),
                                    ((37, 90), (71, 20)),
                                    ((64, 64), (64, 31)),
                                    ((5, 300), (3, 301))])
def test_bicubic_resize_matches_pil(hw, out):
  """`image_io.resize_bicubic` against Pillow's `Image.resize(...,
  BICUBIC)` on uint8 RGB, down and up, bit for bit."""
  from PIL import Image
  img = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3),
                                               dtype=np.uint8)
  want = np.asarray(Image.fromarray(img).resize((out[1], out[0]),
                                                Image.BICUBIC))
  np.testing.assert_array_equal(image_io.resize_bicubic(img, *out), want)


def test_jpeg_folder_without_pil_raises_naming_the_cache(tmp_path,
                                                         monkeypatch):
  """Without PIL a JPEG folder cannot be decoded: loading raises and names
  `celeba_64.npz`, which a machine with PIL writes; with the cache present
  nothing is decoded."""
  import builtins
  os.makedirs(tmp_path / "celeba")
  (tmp_path / "celeba" / "000001.jpg").write_bytes(b"\xff\xd8\xff")
  (tmp_path / "celeba" / "000002.jpg").write_bytes(b"\xff\xd8\xff")
  real_import = builtins.__import__

  def no_pil(name, *args, **kwargs):
    if name == "PIL" or name.startswith("PIL."):
      raise ImportError("no PIL")
    return real_import(name, *args, **kwargs)

  monkeypatch.setattr(builtins, "__import__", no_pil)
  _, tc = configs(NLL, {"datadir": str(tmp_path)})
  with pytest.raises(RuntimeError, match="celeba_64.npz"):
    torch_data.load_arrays(tc)
  arrays = np.zeros((2, 64, 64, 3), np.uint8)
  np.savez_compressed(tmp_path / "celeba_64.npz", train=arrays,
                      test=arrays[:1])
  train, test = torch_data.load_arrays(tc)
  assert train.shape == (2, 64, 64, 3) and test.shape == (1, 64, 64, 3)


def test_image_folder_of_another_dataset_raises(tmp_path):
  """Only CelebA's image folder is read: a folder of another dataset
  raises and names the `.npz` that gives its arrays."""
  _, tc = configs(NLL, {"datadir": str(tmp_path)})
  tc.data.dataset = "LSUN"
  os.makedirs(tmp_path / "lsun")
  for i in range(2):
    image_io.write_png(str(tmp_path / "lsun" / f"{i}.png"),
                       np.zeros((8, 8, 3), np.uint8), 2)
  with pytest.raises(NotImplementedError, match="lsun.npz"):
    torch_data.load_arrays(tc)
