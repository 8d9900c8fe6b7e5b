"""The wolf discriminators and priors of the port against the JAX package:
the Gaussian discriminator with the GroupNorm encoder (an edited preset, as
no preset reaches it) and with the normal prior, the transposed-conv
GroupNorm block, the base and categorical discriminators, the dispatch over
the 22 presets, and what still raises in the port raising in the JAX
package too (a categorical preset in a joint step, a coupling type other
than conv).

Tolerances: the posterior (mu, logvar) and h to 1e-5, the KL to 1e-4
(`tests/test_torch_train_step.py`'s), the GroupNorm blocks to 1e-5.
"""

import copy

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
from indm_torch.flows import wolf as torch_wolf
from indm_torch.flows import wolf_extras as torch_extras
from indm_torch.models.ncsnpp import NCSNpp
from indm_tpu import configs as jax_configs
from indm_tpu import joint as jax_joint
from indm_tpu import sde as jax_sde
from indm_tpu import state as jax_state
from indm_tpu.configs import wolf_presets as jax_presets
from indm_tpu.flows import flow_model as jax_fm
from indm_tpu.flows import wolf as jax_wolf
from indm_tpu.flows import wolf_extras as jax_extras
from indm_tpu.models import create_model as jax_create_model
from test_torch_wolf_presets import PREFIX, PRESETS
from torch_threads import one_torch_thread  # noqa: F401

NAME = "vp/CIFAR10/indm_nll"
B = 4


def _np(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


def tiny_wolf(disc):
  """The tiny resflow wolf of `test_torch_train_step.py` with the
  discriminator `disc`."""
  params = copy.deepcopy(tts.TINY_WOLF)
  params["discriminator"] = disc
  return params


GN_DISC = {"type": "gaussian",
           "encoder": {"type": "global_resnet_gn", "levels": 3,
                       "in_planes": 3, "hidden_planes": [4, 8, 8],
                       "num_groups": [2, 4, 2], "out_planes": 8,
                       "activation": "elu"},
           "in_dim": 8, "dim": 64,
           "prior": {"type": "normal"}}
CAT_DISC = {"type": "categorical", "num_events": 10, "dim": 6,
            "activation": "elu", "probs": [0.05] * 5 + [0.15] * 5}


def models(disc, name):
  """Both packages' flow models on the tiny wolf with `disc`, registered
  as `name`; the JAX (params, buffers) carried over."""
  jax_presets.PRESETS[name] = tiny_wolf(disc)
  torch_presets.PRESETS[name] = tiny_wolf(disc)
  jc = jax_configs.get_config(NAME)
  tc = torch_configs.get_config(NAME)
  for k, v in {**tts.TINY, "flow.model_config": name}.items():
    tts._set(jc, k, v)
    tts._set(tc, k, v)
  fm = jax_fm.create_flow_model(jc)
  params, buffers = fm.init(jax.random.PRNGKey(1))
  params = {**params, "disc": jax.tree_util.tree_map(
      lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(3), a.shape),
      params["disc"])}
  flow = torch_fm.FlowModel(tc)
  flow.load_state_dict(convert.flow_state_dict_from_jax(
      _np(params), tc, _np(buffers.get("batch_stats"))), strict=True)
  return jc, tc, fm, params, buffers, flow


@pytest.fixture(scope="module")
def gn_models():
  yield models(GN_DISC, "tiny-gn")
  jax_presets.PRESETS.pop("tiny-gn", None)
  torch_presets.PRESETS.pop("tiny-gn", None)


def test_gn_encoder_and_normal_prior_match_jax(gn_models):
  """The GroupNorm encoder's posterior, h from the injected draw and the
  normal prior's closed-form KL, in train mode (GroupNorm has no
  statistics to move)."""
  jc, tc, fm, params, buffers, flow = gn_models
  disc = flow.discriminator
  assert isinstance(disc.encoder.net.resnet0.main[0], torch_wolf.ResNetBlockGN)
  assert disc.prior_type == "normal" and not hasattr(disc, "prior")
  x = np.random.default_rng(2).uniform(-1, 1, (B, 8, 8, 3)).astype(
      np.float32)
  rng = jax.random.PRNGKey(4)
  dvars = {"params": params["disc"], "batch_stats": {}}
  (mu_j, lv_j) = fm.disc.apply(dvars, jnp.asarray(x), train=True)
  h_j, kl_j = fm.disc.apply(dvars, jnp.asarray(x), train=True,
                            method=fm.disc.sampling_and_KL,
                            rngs={"sample": rng})
  eps = fm.disc.apply(dvars, method=lambda m: jax.random.normal(
      m.make_rng("sample"), (B, 1, m.dim)), rngs={"sample": rng})
  mu_t, lv_t = disc(tts._nchw(x))
  np.testing.assert_allclose(mu_t.detach().numpy(), np.asarray(mu_j),
                             rtol=1e-5, atol=1e-5)
  np.testing.assert_allclose(lv_t.detach().numpy(), np.asarray(lv_j),
                             rtol=1e-5, atol=1e-5)
  h_t, kl_t = disc.sampling_and_kl(tts._nchw(x), torch.from_numpy(
      np.array(eps).reshape(B, -1)))
  np.testing.assert_allclose(h_t.detach().numpy(), np.asarray(h_j),
                             rtol=1e-5, atol=1e-5)
  np.testing.assert_allclose(kl_t.detach().numpy(), np.asarray(kl_j),
                             rtol=1e-4, atol=1e-4)
  want = jax_extras.NormalPrior().calc_kl(None, None, mu_j, lv_j)
  np.testing.assert_allclose(
      torch_extras.NormalPrior.calc_kl(None, None, mu_t, lv_t)
      .detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
  e = torch.randn(3, 64)
  assert torch.equal(disc.sample_from_prior(3, epsilon=e), e)


def test_gn_wolf_step_losses_match_jax(gn_models):
  """flow_forward(train=True) through the GN encoder, the normal prior and
  the tiny resflow, with the JAX draws replayed: z to 1e-5, log|det| - KL
  to 1e-4."""
  jc, tc, fm, params, buffers, flow = gn_models
  x = np.random.default_rng(5).uniform(-1, 1, (B, 8, 8, 3)).astype(
      np.float32)
  rng = jax.random.PRNGKey(8)
  z_j, ld_j, _ = jax_fm.flow_forward(jc, fm, params, buffers,
                                     jnp.asarray(x), rng=rng, train=True)
  noise = tts.replay_flow_noise(fm, params, {"batch_stats": {}}, rng,
                                x.shape)
  z_t, ld_t = torch_fm.flow_forward(tc, flow.train(), tts._nchw(x),
                                    train=True, noise=noise)
  np.testing.assert_allclose(tts._nhwc(z_t), np.asarray(z_j), rtol=1e-5,
                             atol=1e-5)
  np.testing.assert_allclose(ld_t.detach().numpy(), np.asarray(ld_j),
                             rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("stride", [1, 2])
def test_deresnet_block_gn_matches_jax(stride):
  """The transposed-conv block of the local encoders: lax's SAME
  transposed conv (output H * stride), GroupNorm, the residual's 1x1."""
  x = np.random.default_rng(6).normal(size=(2, 4, 4, 6)).astype(np.float32)
  mj = jax_wolf.DeResNetBlockGN(8, num_groups=2, stride=stride)
  v = mj.init(jax.random.PRNGKey(0), jnp.asarray(x))
  v = jax.tree_util.tree_map(
      lambda a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(1), a.shape),
      v)
  mt = torch_wolf.DeResNetBlockGN(6, 8, 2, stride)
  p = v["params"]
  sd = {}
  for i, (conv, gn) in enumerate((("conv1", "gn1"), ("conv2", "gn2"),
                                  ("downsample.0", "downsample.1"))):
    sd[f"{conv}.weight"] = torch.from_numpy(np.ascontiguousarray(
        np.asarray(p[f"ConvTranspose_{i}"]["kernel"]).transpose(3, 2, 0, 1)))
    sd[f"{gn}.weight"] = torch.from_numpy(np.asarray(p[f"GroupNorm_{i}"]
                                                     ["scale"]))
    sd[f"{gn}.bias"] = torch.from_numpy(np.asarray(p[f"GroupNorm_{i}"]
                                                   ["bias"]))
  mt.load_state_dict(sd, strict=True)
  y_j = mj.apply(v, jnp.asarray(x))
  y_t = mt(tts._nchw(x))
  assert y_t.shape[2] == 4 * stride
  np.testing.assert_allclose(tts._nhwc(y_t), np.asarray(y_j), rtol=1e-5,
                             atol=1e-5)


def test_base_discriminator():
  d = torch_extras.BaseDiscriminator()
  h, kl = d.sampling_and_kl(torch.zeros(3, 3, 4, 4))
  assert h is None and torch.equal(kl, torch.zeros(3))
  assert d.sample_from_prior(3) is None and list(d.parameters()) == []
  hj, klj = jax_extras.BaseDiscriminator().sampling_and_KL(jnp.zeros((3,)))
  assert hj is None and np.asarray(klj).shape == (3,)


def test_categorical_discriminator_matches_jax():
  """h = MLP(embed(y)) with KL 0 for given labels and for the prior's
  labels (injected); the labels' draw follows the logits; both refuse to
  encode without labels."""
  mj = jax_extras.CategoricalDiscriminator(**{
      k: v for k, v in CAT_DISC.items() if k != "type"})
  y = np.array([0, 3, 9, 3], np.int32)
  v = mj.init({"params": jax.random.PRNGKey(0)}, None, y=jnp.asarray(y),
              method=mj.sampling_and_KL)
  v = jax.tree_util.tree_map(
      lambda a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(1), a.shape),
      v)
  disc = torch_wolf.make_discriminator(tiny_wolf(CAT_DISC), 8, 3)
  assert isinstance(disc, torch_extras.CategoricalDiscriminator)
  disc.load_state_dict(convert._categorical(_np(v["params"])), strict=True)
  h_j, kl_j = mj.apply(v, None, y=jnp.asarray(y), method=mj.sampling_and_KL)
  h_t, kl_t = disc.sampling_and_kl(None, y=torch.from_numpy(y))
  np.testing.assert_allclose(h_t.detach().numpy(), np.asarray(h_j),
                             rtol=1e-5, atol=1e-5)
  assert not kl_t.any() and not np.asarray(kl_j).any()
  rng = jax.random.PRNGKey(2)
  hs_j = mj.apply(v, 4, method=mj.sample_from_prior, rngs={"sample": rng})
  ys = mj.apply(v, method=lambda m: jax.random.categorical(
      m.make_rng("sample"), jnp.asarray(m._logits), shape=(4,)),
      rngs={"sample": rng})
  hs_t = disc.sample_from_prior(4, y=torch.from_numpy(np.asarray(ys)))
  np.testing.assert_allclose(hs_t.numpy(), np.asarray(hs_j), rtol=1e-5,
                             atol=1e-5)
  labels = disc.sample_labels(20000, torch.Generator().manual_seed(0))
  freq = torch.bincount(labels, minlength=10).float() / 20000
  np.testing.assert_allclose(freq.numpy(), CAT_DISC["probs"], atol=0.01)
  with pytest.raises(AssertionError, match="labels"):
    mj.apply(v, None, method=mj.sampling_and_KL)
  with pytest.raises(ValueError, match="labels"):
    disc.sampling_and_kl(torch.zeros(2, 3, 8, 8))


def test_make_discriminator_over_the_22_presets():
  """Each preset's discriminator type (and prior and encoder) in the port
  is the JAX package's."""
  for preset in PRESETS:
    params = torch_presets.load_wolf_params(PREFIX + preset)
    d = params["discriminator"]
    img = 2 ** (len((d.get("encoder") or {}).get("hidden_planes", [])) + 1)
    ch = (d.get("encoder") or {}).get("in_planes", 3)
    t = torch_wolf.make_discriminator(params, img, ch, device="meta")
    j = jax_wolf.make_discriminator(params)
    assert type(t).__name__ == type(j).__name__, preset
    if d["type"] == "gaussian":
      assert t.prior_type == j.prior_type and t.dim == j.dim, preset


def test_categorical_preset_in_a_joint_step_raises_in_both():
  """The JAX joint steps pass no labels (`indm_tpu/joint.py:64`), so a
  categorical preset fails there (`wolf_extras.py:92`); the port's joint
  step fails the same way, with a message that says why."""
  name = "tiny-cat"
  jax_presets.PRESETS[name] = torch_presets.PRESETS[name] = tiny_wolf(
      CAT_DISC)
  try:
    jc = jax_configs.get_config(NAME)
    tc = torch_configs.get_config(NAME)
    for k, v in {**tts.TINY, "flow.model_config": name}.items():
      tts._set(jc, k, v)
      tts._set(tc, k, v)
    fm = jax_fm.create_flow_model(jc)
    module, variables = jax_create_model(jc, jax.random.PRNGKey(0))
    f_params, f_buffers = fm.init(jax.random.PRNGKey(1))
    opt = jax_state.make_optimizer(jc)
    ss = jax_state.init_train_state(jc, variables["params"], {}, opt,
                                    jax.random.PRNGKey(2))
    fs = jax_state.init_train_state(jc, f_params, f_buffers, opt,
                                    jax.random.PRNGKey(3))
    step = jax_joint.make_joint_step_fn(jc, jax_sde.get_sde(jc), module, fm,
                                        opt, opt)
    batch = jnp.zeros((B, 8, 8, 3))
    with pytest.raises(AssertionError, match="labels"):
      step((ss, fs), batch)
    flow = torch_fm.FlowModel(tc)
    losses = torch_joint.make_joint_losses(tc, torch_sde.get_sde(tc),
                                           NCSNpp(tc), flow)
    with pytest.raises(ValueError, match="class labels"):
      losses(torch.zeros(B, 3, 8, 8))
  finally:
    jax_presets.PRESETS.pop(name, None)
    torch_presets.PRESETS.pop(name, None)


def test_other_coupling_types_raise_in_both():
  params = torch_presets.load_wolf_params(
      PREFIX + "cifar10/glow/glow-base-uni.json")
  params["generator"]["flow"]["coupling_type"] = "self_attn"
  name = "tiny-attn"
  jax_presets.PRESETS[name] = torch_presets.PRESETS[name] = params
  try:
    for cfgs, mod, err in ((jax_configs, jax_fm, AssertionError),
                           (torch_configs, torch_fm, NotImplementedError)):
      c = cfgs.get_config(NAME)
      c.flow.model_config = name
      with pytest.raises(err, match="coupling_type"):
        (mod.create_flow_model(c) if mod is jax_fm
         else mod.FlowModel(c, device="meta"))
  finally:
    jax_presets.PRESETS.pop(name, None)
    torch_presets.PRESETS.pop(name, None)
