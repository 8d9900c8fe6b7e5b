"""Helpers of `test_torch_glow_kinds.py` and `test_torch_macow_kinds.py`:
one wolf preset of each generator and discriminator kind against the JAX
package.

Glow and MaCow, each with the gaussian, base and categorical
discriminators (the categorical given labels, as only `flow_forward(y=...)`
can), and the gaussian's normal prior, at widths shrunk as
`tests/test_wolf_flows.py:_shrink_widths` shrinks them and one step where
the preset has several (every level and multi-scale prior kept): the JAX
weights
carried over, the posterior draw replayed, z to 1e-5 of its largest value,
log|det| - KL to 1e-4, the encoder's BatchNorm statistics to 1e-5; for
Glow also the gradients of sum(logdet_kl) + <z, w> to rtol 1e-4 and 1e-5
of the tensor's largest value (the 1x1 convs' gradients, -H W inv(W)^T
among them, reach 70 and differ by float32 roundings of the inverse).
MaCow's gradients are held on a small MaCow by `test_torch_wolf_macow.py`.
Then the reverse direction with the prior's draw replayed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train_step as tts
from indm_torch import convert
from indm_torch.configs import wolf_presets as torch_presets
from indm_torch.flows import flow_model as torch_fm
from indm_tpu import configs as jax_configs
from indm_tpu.configs import wolf_presets as jax_presets
from indm_tpu.flows import flow_model as jax_fm
from test_torch_wolf_presets import B, PREFIX, preset_config
from test_wolf_flows import _shrink_widths


def _np(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


# one preset of each generator x discriminator kind, and the normal prior
KINDS = {
    "glow_gaussian": ("cifar10/glow/glow-gaussian-uni.json", None),
    "glow_base": ("cifar10/glow/glow-base-uni.json", None),
    "glow_categorical": ("cifar10/glow/glow-cat-uni.json", None),
    "macow_gaussian": ("cifar10/macow/macow-gaussian-uni.json", None),
    "macow_base": ("cifar10/macow/macow-base-uni.json", None),
    "macow_categorical": ("cifar10/macow/macow-cat-uni.json", None),
    "glow_gaussian_normal_prior": ("cifar10/glow/glow-gaussian-uni.json",
                                   {"type": "normal"}),
}


def kind_setup(kind):
  """Both packages' flows at the shrunk preset of `kind` (registered under
  "tiny-<kind>"), the JAX weights moved off their init."""
  preset, prior = KINDS[kind]
  params = _shrink_widths(torch_presets.load_wolf_params(PREFIX + preset))
  gen = params["generator"]["flow"]
  # one step where the preset has several: every level and prior kept
  gen["num_steps"] = [[1] * len(e) if isinstance(e, list) else 1
                      for e in gen["num_steps"]]
  if prior is not None:
    params["discriminator"]["prior"] = prior
  key = f"tiny-{kind}"
  jax_presets.PRESETS[key] = params
  torch_presets.PRESETS[key] = params
  jc, _ = preset_config(preset, jax_configs)
  tc, _ = preset_config(preset)
  jc.flow.model_config = tc.flow.model_config = key
  fm = jax_fm.create_flow_model(jc)
  f_params, f_buffers = fm.init(jax.random.PRNGKey(1))
  leaves, tree = jax.tree_util.tree_flatten(f_params)
  keys = jax.random.split(jax.random.PRNGKey(5), len(leaves))
  f_params = jax.tree_util.tree_unflatten(tree, [
      a + 0.03 * jax.random.normal(k, a.shape) for a, k in zip(leaves, keys)])
  flow = torch_fm.FlowModel(tc)
  flow.load_state_dict(convert.flow_state_dict_from_jax(
      _np(f_params), tc, _np(f_buffers.get("batch_stats"))), strict=True)
  return dict(jc=jc, tc=tc, fm=fm, params=f_params, buffers=f_buffers,
              flow=flow.train(), raw=params, key=key)


def enc_eps(s, rng, b):
  """The Gaussian posterior's draw of `jax_fm.flow_forward(rng=rng)`."""
  if s["raw"]["discriminator"]["type"] != "gaussian":
    return None
  rng_h, _ = jax.random.split(rng)
  eps = s["fm"].disc.apply(
      {"params": s["params"]["disc"],
       "batch_stats": s["buffers"]["batch_stats"]},
      method=lambda m: jax.random.normal(m.make_rng("sample"), (b, 1, m.dim)),
      rngs={"sample": rng_h})
  return torch.from_numpy(np.array(eps).reshape(b, -1))


def kind_fixture(kinds):
  """A module fixture over `kinds`: each kind's setup, its presets
  unregistered after it."""

  @pytest.fixture(scope="module", params=kinds)
  def kind(request):
    s = kind_setup(request.param)
    yield s
    jax_presets.PRESETS.pop(s["key"], None)
    torch_presets.PRESETS.pop(s["key"], None)

  return kind


def check_forward(s):
  """The encoding direction, both packages on the same draws."""
  size = s["tc"].data.image_size
  rng = np.random.default_rng(4)
  x = rng.uniform(-1, 1, (B, size, size, 3)).astype(np.float32)
  w = rng.normal(size=x.shape).astype(np.float32)
  categorical = s["raw"]["discriminator"]["type"] == "categorical"
  y = np.array([3, 7], np.int32) if categorical else None
  key = jax.random.PRNGKey(6)

  def loss(p):
    z, ld, nb = jax_fm.flow_forward(s["jc"], s["fm"], p, s["buffers"],
                                    jnp.asarray(x), rng=key, train=True,
                                    y=None if y is None else jnp.asarray(y))
    return jnp.sum(ld) + jnp.sum(z * w), (z, ld, nb)

  grads = s["fm"].gen_kind == "glow"
  if grads:
    (_, (z_j, ld_j, nb)), g_j = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(s["params"])
  else:
    _, (z_j, ld_j, nb) = jax.jit(loss)(s["params"])
  flow = s["flow"]
  z_t, ld_t = torch_fm.flow_forward(
      s["tc"], flow, tts._nchw(x), train=True,
      noise=torch_fm.FlowNoise(enc_eps(s, key, B), []),
      y=None if y is None else torch.from_numpy(y).long())
  z_j = np.asarray(z_j)
  np.testing.assert_allclose(tts._nhwc(z_t), z_j, rtol=0,
                             atol=1e-5 * np.abs(z_j).max())
  np.testing.assert_allclose(ld_t.detach().numpy(), np.asarray(ld_j),
                             rtol=1e-4, atol=1e-4)
  got = flow.state_dict()
  if grads:
    (ld_t.sum() + (z_t * tts._nchw(w)).sum()).backward()
    want = convert.flow_state_dict_from_jax(_np(g_j), s["tc"])
  for name, p in flow.named_parameters() if grads else ():
    assert p.grad is not None, name
    big = max(1.0, float(np.abs(want[name].numpy()).max()))
    np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                               rtol=1e-4, atol=1e-5 * big, err_msg=name)
  want = convert.flow_state_dict_from_jax(
      _np(s["params"]), s["tc"], _np(nb.get("batch_stats")))
  stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
  assert bool(stats) == (s["raw"]["discriminator"]["type"] == "gaussian")
  for k in stats:
    np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5,
                               atol=1e-5, err_msg=k)


def check_reverse(s):
  """Sampling: h from the prior (the Gaussian's epsilon or the
  categorical's labels replayed; none for base), then the generator's
  sampling direction; and its round trip through the encoding one."""
  size = s["tc"].data.image_size
  x = np.random.default_rng(8).normal(size=(B, size, size, 3)).astype(
      np.float32) * 0.5
  key = jax.random.PRNGKey(9)
  z_j, _, _ = jax_fm.flow_forward(s["jc"], s["fm"], s["params"],
                                  s["buffers"], jnp.asarray(x), rng=key,
                                  reverse=True)
  rng_h, _ = jax.random.split(key)
  kind_ = s["raw"]["discriminator"]["type"]
  kw = {}
  if kind_ != "base":
    dvars = {"params": s["params"]["disc"],
             "batch_stats": s["buffers"].get("batch_stats", {})}
    if kind_ == "gaussian":
      draw = lambda m: jax.random.normal(m.make_rng("sample"), (B, m.dim))
      kw["prior_eps"] = torch.from_numpy(np.array(s["fm"].disc.apply(
          dvars, method=draw, rngs={"sample": rng_h})))
    else:
      draw = lambda m: jax.random.categorical(
          m.make_rng("sample"), jnp.asarray(m._logits), shape=(B,))
      kw["y"] = torch.from_numpy(np.array(s["fm"].disc.apply(
          dvars, method=draw, rngs={"sample": rng_h}))).long()
  flow = s["flow"].eval()
  z_t, _ = torch_fm.flow_forward(s["tc"], flow, tts._nchw(x), reverse=True,
                                 **kw)
  z_j = np.asarray(z_j)
  np.testing.assert_allclose(tts._nhwc(z_t), z_j, rtol=0,
                             atol=1e-5 * np.abs(z_j).max())
  if kind_ == "base":
    back, _ = torch_fm.flow_forward(s["tc"], flow, z_t)
    np.testing.assert_allclose(back.numpy(), tts._nchw(x).numpy(), atol=1e-4)


