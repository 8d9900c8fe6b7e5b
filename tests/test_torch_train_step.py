"""The port's joint training step (`indm_torch.joint`) against the JAX
package's `step_nll`, and its flow pieces on the way: the wolf encoder with
its BatchNorm buffers, `sampling_and_kl`, `calc_kl`, the prior density and
`flow_forward(train=True)`.

Geometry: the tiny wolf preset of `tests/test_joint.py`, registered on both
sides, with a two-scale flow (`nblocks="2-2"`, so the squeeze between the
scales is covered), `model.init_scale = 1.0`, `model.dropout = 0` (threefry
dropout masks cannot be replayed), and the slice's configuration
`model.fused_groupnorm = flow.logdet_pallas = True`, whose Pallas kernels
run in interpret mode on the JAX side. The JAX weights cross over through
`indm_torch.convert`; every draw of the JAX step is rebuilt from its key
tree and handed to the port. The JAX step runs once per module with
optimizers that record the gradients instead of applying them, so that the
gradients are compared before any update; the AdamW update and the EMA are
then compared on identical gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from indm_torch import configs as torch_configs
from indm_torch import convert
from indm_torch import ema as torch_ema
from indm_torch import joint as torch_joint
from indm_torch import optim as torch_optim
from indm_torch import sde as torch_sde
from indm_torch.configs import wolf_presets as torch_presets
from indm_torch.flows import flow_model as torch_fm
from indm_torch.models.ncsnpp import NCSNpp
from indm_tpu import configs as jax_configs
from indm_tpu import ema as jax_ema
from indm_tpu import joint as jax_joint
from indm_tpu import sde as jax_sde
from indm_tpu import state as jax_state
from indm_tpu.configs import wolf_presets as jax_presets
from indm_tpu.flows import flow_model as jax_fm
from indm_tpu.flows import resflow as jax_resflow
from indm_tpu.models import create_model as jax_create_model
from torch_threads import one_torch_thread  # noqa: F401

TINY_WOLF = {
    "generator": {"flow": {"type": "resflow"}},
    "discriminator": {
        "type": "gaussian",
        "encoder": {"type": "global_resnet_bn", "levels": 3,
                    "in_planes": 3, "hidden_planes": [4, 8, 8],
                    "out_planes": 8, "activation": "elu"},
        "in_dim": 8, "dim": 64,
        "prior": {"type": "flow", "num_steps": 1, "in_features": 64,
                  "hidden_features": 16, "activation": "elu",
                  "transform": "affine", "alpha": 1.0,
                  "coupling_type": "mlp"},
    },
    "dequantizer": {"type": "uniform"},
}
TINY = {"data.image_size": 8, "model.nf": 8, "model.num_res_blocks": 1,
        "model.ch_mult": (1, 1), "model.attn_resolutions": (4,),
        "model.init_scale": 1.0, "model.dropout": 0.0,
        "model.fused_groupnorm": True, "training.batch_size": 4,
        "flow.nblocks": "2-2", "flow.intermediate_dim": 8,
        "flow.logdet_pallas": True, "flow.model_config": "tiny-train"}
B = 4


def _set(cfg, name, value):
  *path, leaf = name.split(".")
  node = cfg
  for p in path:
    node = getattr(node, p)
  setattr(node, leaf, value)


def _np(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


def _nchw(a):
  return torch.from_numpy(np.ascontiguousarray(
      np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
  return t.detach().permute(0, 2, 3, 1).numpy()


def _record_grads():
  """An optax 'optimizer' that leaves the parameters as they are and keeps
  the gradients it was given in its state."""

  def init(params):
    return {"g": jax.tree_util.tree_map(jnp.zeros_like, params)}

  def update(grads, state, params=None):
    return jax.tree_util.tree_map(jnp.zeros_like, grads), {"g": grads}

  return optax.GradientTransformation(init, update)


def replay_blocks(resflow, rng, shape):
  """Each iResBlock's (vareps NHWC, n) as `ResidualFlow.forward(rng=rng)`
  draws them: split per scale, per layer, per block of a scanned stack,
  then (rng_n, rng_eps) per block."""
  b, h, w, c = shape
  out = []
  for t, k_scale in zip(resflow.transforms,
                        jax.random.split(rng, resflow.n_scale)):
    for layer, k in zip(t.layers, jax.random.split(k_scale, len(t.layers))):
      if isinstance(layer, jax_resflow.IResBlock):
        keys = [k]
      elif isinstance(layer, jax_resflow.ScannedIResBlocks):
        keys = list(jax.random.split(k, layer.n))
      else:  # the squeeze
        h, w, c = h // 2, w // 2, c * 4
        continue
      for kb in keys:
        rng_n, rng_eps = jax.random.split(kb)
        out.append((np.asarray(jax.random.normal(rng_eps, (b, h, w, c))),
                    int(jax.random.poisson(rng_n, 2.0))))
  return out


def replay_flow_noise(fm, params, buffers, rng, shape):
  """The draws of `jax_fm.flow_forward(rng=rng, train=True)`: the encoder's
  posterior eps from the discriminator's 'sample' stream, and the blocks'."""
  rng_h, rng_f = jax.random.split(rng)
  eps = fm.disc.apply(
      {"params": params["disc"], "batch_stats": buffers["batch_stats"]},
      method=lambda m: jax.random.normal(m.make_rng("sample"),
                                         (shape[0], 1, m.dim)),
      rngs={"sample": rng_h})
  blocks = replay_blocks(fm.resflow, rng_f, shape)
  return torch_fm.FlowNoise(
      torch.from_numpy(np.array(eps).reshape(shape[0], -1)),
      [(_nchw(v), n) for v, n in blocks])


def replay_step_noise(fm, f_params, f_buffers, score_rng, shape):
  """Every draw of one JAX `step_nll` from the score state's key."""
  _, step_rng = jax.random.split(score_rng)
  (k,) = jax.random.split(step_rng, 1)
  r_flow, r_score, r_logp = jax.random.split(k, 3)
  _, rng_t, rng_z, _, _, _ = jax.random.split(r_score, 6)
  return torch_joint.StepNoise(
      replay_flow_noise(fm, f_params, f_buffers, r_flow, shape),
      torch.from_numpy(np.array(jax.random.uniform(rng_t, (shape[0],)))),
      _nchw(jax.random.normal(rng_z, shape)),
      _nchw(jax.random.normal(r_logp, shape)))


def jax_step_setup(overrides=None, compiler_options=None):
  """Generator: the JAX step at the tiny geometry (TINY with `overrides`)
  run once with gradient-recording optimizers (jitted with XLA's
  `compiler_options`), and both configs; yields a dict and unregisters the
  tiny wolf preset when resumed."""
  jax_presets.PRESETS["tiny-train"] = TINY_WOLF
  torch_presets.PRESETS["tiny-train"] = TINY_WOLF
  jc = jax_configs.get_config("vp/CIFAR10/indm_nll")
  tc = torch_configs.get_config("vp/CIFAR10/indm_nll")
  for k, v in {**TINY, **(overrides or {})}.items():
    _set(jc, k, v)
    _set(tc, k, v)
  module, variables = jax_create_model(jc, jax.random.PRNGKey(0))
  fm = jax_fm.create_flow_model(jc)
  f_params, f_buffers = fm.init(jax.random.PRNGKey(1))
  opt = _record_grads()
  ss = jax_state.init_train_state(jc, variables["params"], {}, opt,
                                  jax.random.PRNGKey(2))
  fs = jax_state.init_train_state(jc, f_params, f_buffers, opt,
                                  jax.random.PRNGKey(3))
  step = jax_joint.make_joint_step_fn(jc, jax_sde.get_sde(jc), module, fm,
                                      opt, opt, train=True)
  batch = np.random.default_rng(4).uniform(-1, 1, (B, 8, 8, 3)).astype(
      np.float32)
  (ss2, fs2), metrics = jax.jit(step, compiler_options=compiler_options)(
      (ss, fs), jnp.asarray(batch))
  yield dict(jc=jc, tc=tc, module=module, variables=variables, fm=fm,
             f_params=f_params, f_buffers=f_buffers, ss=ss, ss2=ss2, fs2=fs2,
             metrics=[np.asarray(m) for m in metrics], batch=batch)
  jax_presets.PRESETS.pop("tiny-train", None)
  torch_presets.PRESETS.pop("tiny-train", None)


@pytest.fixture(scope="module")
def setup():
  yield from jax_step_setup()


def port_models(s):
  tc = s["tc"]
  score = NCSNpp(tc)
  score.load_state_dict(convert.score_state_dict_from_jax(
      _np(s["variables"]["params"]), tc), strict=True)
  flow = torch_fm.FlowModel(tc)
  flow.load_state_dict(convert.flow_state_dict_from_jax(
      _np(s["f_params"]), tc, _np(s["f_buffers"]["batch_stats"])),
                       strict=True)
  return score.train(), flow.train()


def _disc_vars(s):
  return {"params": s["f_params"]["disc"],
          "batch_stats": s["f_buffers"]["batch_stats"]}


def test_encoder_and_batchnorm_buffers_match(setup):
  """Posterior (mu, logvar) in train mode and the BatchNorm running
  statistics after it, to 1e-5."""
  s = setup
  (mu, logvar), upd = s["fm"].disc.apply(
      _disc_vars(s), jnp.asarray(s["batch"]), train=True,
      mutable=["batch_stats"])
  _, flow = port_models(s)
  mu_t, logvar_t = flow.discriminator(_nchw(s["batch"]))
  np.testing.assert_allclose(mu_t.detach().numpy(), np.asarray(mu),
                             rtol=1e-5, atol=1e-5)
  np.testing.assert_allclose(logvar_t.detach().numpy(), np.asarray(logvar),
                             rtol=1e-5, atol=1e-5)
  want = convert.flow_state_dict_from_jax(_np(s["f_params"]), s["tc"],
                                          _np(upd["batch_stats"]))
  got = flow.state_dict()
  names = [k for k in want if k.endswith(("running_mean", "running_var"))]
  assert len(names) == 2 * 17  # 6 blocks, 5 with a downsample
  for k in names:
    np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5,
                               atol=1e-5, err_msg=k)


def test_sampling_and_kl_and_prior_density_match(setup):
  """`sampling_and_kl` with the JAX draw of eps, `calc_kl` and
  `PriorFlow.density`, in eval mode: 1e-5 (the prior's slogdet of the
  64x64 weight, 1e-4)."""
  s = setup
  x = jnp.asarray(s["batch"])
  rng = jax.random.PRNGKey(5)
  h_j, kl_j = s["fm"].disc.apply(_disc_vars(s), x, train=False,
                                 method=s["fm"].disc.sampling_and_KL,
                                 rngs={"sample": rng})
  eps = s["fm"].disc.apply(
      _disc_vars(s), method=lambda m: jax.random.normal(
          m.make_rng("sample"), (B, 1, m.dim)), rngs={"sample": rng})
  _, flow = port_models(s)
  disc = flow.discriminator.eval()
  h_t, kl_t = disc.sampling_and_kl(_nchw(s["batch"]), torch.from_numpy(
      np.array(eps).reshape(B, -1)))
  np.testing.assert_allclose(h_t.detach().numpy(), np.asarray(h_j),
                             rtol=1e-5, atol=1e-5)
  np.testing.assert_allclose(kl_t.detach().numpy(), np.asarray(kl_j),
                             rtol=1e-4, atol=1e-4)
  z = np.random.default_rng(6).normal(size=(B, 64)).astype(np.float32)
  e_j, ld_j = s["fm"].disc.apply(_disc_vars(s), jnp.asarray(z),
                                 method=lambda m, z: m.prior.density(z))
  e_t, ld_t = disc.prior.flow.density(torch.from_numpy(z))
  np.testing.assert_allclose(e_t.detach().numpy(), np.asarray(e_j),
                             rtol=1e-5, atol=1e-5)
  np.testing.assert_allclose(ld_t.detach().numpy(), np.asarray(ld_j),
                             rtol=1e-4, atol=1e-4)


def test_flow_forward_train_matches_with_replayed_noise(setup):
  """The encoding direction: z to 1e-5, log|det| - KL to 1e-4 (the
  estimator sums a few hundred products), the buffers to 1e-5."""
  s = setup
  rng = jax.random.PRNGKey(8)
  z_j, ld_j, nb = jax_fm.flow_forward(
      s["jc"], s["fm"], s["f_params"], s["f_buffers"],
      jnp.asarray(s["batch"]), rng=rng, train=True)
  noise = replay_flow_noise(s["fm"], s["f_params"], s["f_buffers"], rng,
                            s["batch"].shape)
  assert len(noise.blocks) == 4 and noise.blocks[2][0].shape == (B, 12, 4, 4)
  _, flow = port_models(s)
  z_t, ld_t = torch_fm.flow_forward(s["tc"], flow, _nchw(s["batch"]),
                                    train=True, noise=noise)
  np.testing.assert_allclose(_nhwc(z_t), np.asarray(z_j), rtol=1e-5,
                             atol=1e-5)
  np.testing.assert_allclose(ld_t.detach().numpy(), np.asarray(ld_j),
                             rtol=1e-4, atol=1e-4)
  want = convert.flow_state_dict_from_jax(_np(s["f_params"]), s["tc"],
                                          _np(nb["batch_stats"]))
  got = flow.state_dict()
  for k in want:
    if k.endswith(("running_mean", "running_var")):
      np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5,
                                 atol=1e-5, err_msg=k)


def run_port_step(s):
  """The port's joint losses on the JAX step's batch and replayed noise,
  and the gradients of their mean: (score, flow, aux)."""
  score, flow = port_models(s)
  noise = replay_step_noise(s["fm"], s["f_params"], s["f_buffers"],
                            s["ss"].rng, s["batch"].shape)
  losses = torch_joint.make_joint_losses(s["tc"], torch_sde.get_sde(s["tc"]),
                                         score, flow)
  aux = losses(_nchw(s["batch"]), noise)
  aux["losses"].mean().backward()
  return score, flow, aux


@pytest.fixture(scope="module")
def port_step(setup):
  return run_port_step(setup)


def test_step_losses_match(setup, port_step):
  """Per-example losses and their three terms to 1e-4; losses = score +
  flow + logp (`test_joint.py:93-95`)."""
  _, _, aux = port_step
  for name, want in zip(torch_joint.METRICS, setup["metrics"]):
    np.testing.assert_allclose(aux[name].detach().numpy(), want, rtol=1e-4,
                               atol=1e-4, err_msg=name)
  np.testing.assert_allclose(
      aux["losses"].detach().numpy(),
      (aux["losses_score"] + aux["losses_flow"]
       + aux["losses_logp"]).detach().numpy(), rtol=1e-5)


def _grad_pairs(setup, port_step):
  s = setup
  score, flow, _ = port_step
  tc = s["tc"]
  g_score = convert.score_state_dict_from_jax(_np(s["ss2"].opt_state["g"]),
                                              tc)
  g_flow = convert.flow_state_dict_from_jax(_np(s["fs2"].opt_state["g"]), tc)
  for model, want in ((score, g_score), (flow, g_flow)):
    named = dict(model.named_parameters())
    assert set(named) <= set(want)
    for name, p in named.items():
      yield name, p, want[name]


def test_step_gradients_match(setup, port_step):
  """Both nets' gradients before any update, to rtol 1e-4, atol 1e-5."""
  n = 0
  for name, p, want in _grad_pairs(setup, port_step):
    assert p.grad is not None, name
    np.testing.assert_allclose(p.grad.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5, err_msg=name)
    n += 1
  assert n > 100


def test_step_batchnorm_buffers_match(setup, port_step):
  _, flow, _ = port_step
  s = setup
  want = convert.flow_state_dict_from_jax(_np(s["fs2"].params), s["tc"],
                                          _np(s["fs2"].buffers["batch_stats"]))
  got = flow.state_dict()
  for k in want:
    if k.endswith(("running_mean", "running_var")):
      np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5,
                                 atol=1e-5, err_msg=k)


@pytest.mark.parametrize("net", ["score", "flow"])
def test_adamw_and_ema_match_on_identical_grads(setup, net):
  """One AdamW update (clip, b2 = 0.99, decoupled decay, the net's lr) and
  one EMA step from the JAX step's gradients, against optax and
  `indm_tpu.ema`: 1e-6."""
  s = setup
  jc, tc = s["jc"], s["tc"]
  if net == "score":
    params, grads = s["variables"]["params"], s["ss2"].opt_state["g"]
    to_sd = convert.score_state_dict_from_jax
    opt_j, lr, rate = jax_state.make_optimizer(jc), None, jc.model.ema_rate
    model = NCSNpp(tc)
  else:
    params, grads = s["f_params"], s["fs2"].opt_state["g"]
    to_sd = convert.flow_state_dict_from_jax
    opt_j = jax_state.make_optimizer(jc, lr=jc.flow.lr)
    lr, rate = tc.flow.lr, jc.flow.ema_rate
    model = torch_fm.FlowModel(tc)
  updates, _ = opt_j.update(grads, opt_j.init(params), params)
  new_j = optax.apply_updates(params, updates)
  ema_j = jax_ema.ema_update(params, new_j, rate, 1)

  model.load_state_dict(to_sd(_np(params), tc), strict=False)
  names = [n for n, _ in model.named_parameters()]
  g = to_sd(_np(grads), tc)
  for name, p in model.named_parameters():
    p.grad = g[name].clone()
  opt = torch_optim.make_optimizer(tc, model.parameters(), lr=lr)
  ema = torch_ema.EMA(opt.params, rate)
  opt.step()
  ema.update(opt.params)
  want_p, want_e = to_sd(_np(new_j), tc), to_sd(_np(ema_j), tc)
  for name, p, e in zip(names, opt.params, ema.shadow):
    np.testing.assert_allclose(p.detach().numpy(), want_p[name].numpy(),
                               rtol=1e-6, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(e.numpy(), want_e[name].numpy(), rtol=1e-6,
                               atol=1e-6, err_msg=name)


def test_step_nll_updates_both_nets(setup):
  """The whole port step on the replayed noise: the same losses as the JAX
  step, both nets and the BatchNorm buffers changed."""
  s = setup
  tc = s["tc"]
  score, flow = port_models(s)
  before = {k: v.clone() for k, v in {**score.state_dict(),
                                      **flow.state_dict()}.items()}
  opts = [torch_optim.make_optimizer(tc, score.parameters()),
          torch_optim.make_optimizer(tc, flow.parameters(), lr=tc.flow.lr)]
  emas = [torch_ema.EMA(o.params, r) for o, r in
          zip(opts, (tc.model.ema_rate, tc.flow.ema_rate))]
  step = torch_joint.make_joint_step_fn(tc, torch_sde.get_sde(tc), score,
                                        flow, *opts, *emas)
  noise = replay_step_noise(s["fm"], s["f_params"], s["f_buffers"],
                            s["ss"].rng, s["batch"].shape)
  metrics = step(_nchw(s["batch"]), noise)
  np.testing.assert_allclose(metrics[0].numpy(), s["metrics"][0], rtol=1e-4,
                             atol=1e-4)
  after = {**score.state_dict(), **flow.state_dict()}
  moved = {k for k in before if not torch.equal(before[k], after[k])}
  assert any(k.startswith("all_modules.") for k in moved)
  assert any(k.startswith("generator.flow.") for k in moved)
  assert any(k.endswith("running_var") for k in moved)
  assert emas[0].num_updates == emas[1].num_updates == 1
