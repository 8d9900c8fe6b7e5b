"""Helpers of the score-net parity tests (`test_torch_ncsnpp_branches.py`,
`test_torch_ddpm.py`, `test_torch_ncsnv2.py`, `test_torch_vdm.py`): the
same config on both sides, the JAX net's weights carried to the port by
`indm_torch.convert`, and outputs compared relative to their largest
value.

The JAX weights are perturbed by seeded noise of 0.05 before they are
carried across: the nets' last convs start at ~1e-10 (init scale 0), and
an output that is nearly a chain of skips would say nothing about the
blocks.

A parity module imports `unoptimized_xla`, an autouse fixture that turns
off most of XLA's optimizations while the module runs: the JAX nets run op
by op on tiny shapes, where compiling each op with them costs more than
they save.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indm_torch import configs as torch_configs
from indm_torch import convert
from indm_torch.models import registry as torch_registry
from indm_tpu import configs as jax_configs
from indm_tpu.models import create_model as jax_create_model

# the output's tolerance, relative to its largest value
# (`tests/test_torch_score.py:91`)
RTOL = 5e-5
# the score functions' times, two at a time: at the nets' init batch of 2
# the JAX ops compiled for the init serve again
TIMES = np.array([[0.9, 0.4], [0.05, 0.4]], np.float32)
TINY = {"data.image_size": 8, "model.nf": 8, "model.num_res_blocks": 1,
        "model.ch_mult": (1, 1), "model.attn_resolutions": (4,),
        "model.init_scale": 1.0}


@pytest.fixture(autouse=True, scope="module")
def unoptimized_xla():
  """Most XLA optimizations off for the module; the programs compiled
  without them are dropped after it, so that no later module runs them."""
  was = jax.config.read("jax_disable_most_optimizations")
  jax.config.update("jax_disable_most_optimizations", True)
  yield
  jax.config.update("jax_disable_most_optimizations", was)
  jax.clear_caches()


def set_leaf(cfg, name, value):
  *path, leaf = name.split(".")
  node = cfg
  for p in path:
    node = getattr(node, p)
  setattr(node, leaf, value)


def configs(base="vp/CIFAR10/indm_nll", **leaves):
  """(JAX config, port config) of `base` with TINY and `leaves` set on
  both (a leaf neither defines, such as `model.num_classes`, is added)."""
  jc, tc = jax_configs.get_config(base), torch_configs.get_config(base)
  for k, v in {**TINY, **leaves}.items():
    set_leaf(jc, k, v)
    set_leaf(tc, k, v)
  return jc, tc


def np_tree(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


def perturbed(variables, seed=1, scale=0.05):
  """`variables` with seeded normal noise of `scale` added to every
  parameter (the buffers and batch statistics as they are)."""
  if "params" not in variables:
    return variables
  rng = np.random.default_rng(seed)
  params = jax.tree_util.tree_map(
      lambda a: jnp.asarray(np.asarray(a) + scale * rng.standard_normal(
          np.shape(a)).astype(np.float32)), variables["params"])
  return {**variables, "params": params}


def jax_net(jc, seed=0, perturb=True):
  """(module, variables) of `indm_tpu.models.create_model` at key `seed`,
  perturbed."""
  module, variables = jax_create_model(jc, jax.random.PRNGKey(seed))
  return module, perturbed(variables) if perturb else variables


@functools.lru_cache(maxsize=None)
def _nets(base, leaves):
  jc, tc = configs(base, **dict(leaves))
  module, variables = jax_net(jc)
  return jc, tc, module, variables, port_net(tc, variables)


def nets(base="vp/CIFAR10/indm_nll", **leaves):
  """(JAX config, port config, JAX module, perturbed variables, port net in
  eval mode) of `base` with TINY and `leaves`, made once a test module for
  the tests that share them (they only read them)."""
  return _nets(base, tuple(sorted(leaves.items())))


def port_net(tc, variables):
  """The port's net of `model.name` in eval mode with the JAX variables."""
  sd = convert.score_state_dict_from_jax(
      np_tree(variables["params"]), tc, np_tree(variables.get("buffers")),
      np_tree(variables.get("batch_stats")))
  model = torch_registry.model_classes()[tc.model.name](tc)
  model.load_state_dict(sd, strict=True)
  return model.eval()


def nchw(a):
  return torch.from_numpy(np.ascontiguousarray(
      np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
  return t.detach().permute(0, 2, 3, 1).numpy()


def images(b, size, seed=0):
  return np.random.default_rng(seed).normal(size=(b, size, size, 3)).astype(
      np.float32)


def assert_close(got, want, rtol=RTOL):
  """got within rtol of want's largest value, which is not degenerate."""
  scale = np.abs(want).max()
  assert scale > 1e-6
  np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=rtol)


def compare_score_fns(j_fn, t_fn, size):
  """The JAX and port score functions on the same images at TIMES."""
  x = images(2, size, seed=2)
  for t in TIMES:
    want = np.asarray(j_fn(jnp.asarray(x), jnp.asarray(t)))
    got = nhwc(t_fn(nchw(x), torch.from_numpy(t)))
    assert_close(got, want)


def compare_nets(module, variables, model, x, labels, rtol=RTOL):
  """The JAX net and the port's on NHWC `x` and `labels` (numpy), in eval
  mode; returns the JAX output."""
  want = np.asarray(module.apply(variables, jnp.asarray(x),
                                 jnp.asarray(labels), train=False))
  with torch.no_grad():
    got = nhwc(model(nchw(x), torch.from_numpy(labels)))
  assert got.shape == want.shape
  assert_close(got, want, rtol)
  return want


def step_against_jax(jc, tc, module, variables, monkeypatch, b=4):
  """One score-only step (a discrete loss: DDPM or SMLD, dropout off) of
  both packages on one batch, the JAX step's draws replayed into the
  port's (`test_torch_score_only.replay`): the per-example losses within
  1e-5 and each gradient tensor within 1e-4 of its largest value, floored
  at 1e-4 of the net's largest gradient (`test_torch_score_only.py`'s
  limits)."""
  import test_torch_score_only as tso
  import test_torch_train_step as tts
  from indm_torch import ema as torch_ema
  from indm_torch import losses as torch_losses
  from indm_torch import optim as torch_optim
  from indm_torch import sde as torch_sde
  from indm_tpu import losses as jax_losses
  from indm_tpu import sde as jax_sde
  from indm_tpu import state as jax_state
  assert not jc.training.continuous and jc.model.dropout == 0.0
  size = jc.data.image_size
  rec = tts._record_grads()
  ss = jax_state.init_train_state(jc, variables["params"], {}, rec,
                                  jax.random.PRNGKey(2))
  noise, _ = tso.replay(jc, ss.rng, (b, size, size, 3))
  step = jax_losses.make_score_step_fn(jc, jax_sde.get_sde(jc), module, rec)
  batch = np.random.default_rng(4).uniform(-1, 1, (b, size, size, 3)).astype(
      np.float32)
  ss2, losses_j = jax.jit(step)(ss, jnp.asarray(batch))
  model = port_net(tc, variables).train()
  opt = torch_optim.make_optimizer(tc, model.parameters())
  ema = torch_ema.EMA(opt.params, tc.model.ema_rate)
  step_t = torch_losses.make_score_step_fn(tc, torch_sde.get_sde(tc), model,
                                           opt, ema)
  (losses_t,) = step_t(nchw(batch), noise)
  np.testing.assert_allclose(losses_t.numpy(), np.asarray(losses_j),
                             rtol=1e-5, atol=1e-5)
  # gradients carry no offset of a gain from 1
  monkeypatch.setattr(convert, "_plus_one", lambda p, k: convert._t(p[k]))
  want = convert.score_state_dict_from_jax(np_tree(ss2.opt_state["g"]), tc)
  grads = dict(model.named_parameters())
  assert set(grads) <= set(want) and len(grads) > 20
  floor = 1e-4 * max(want[k].abs().max().item() for k in grads)
  for name, p in grads.items():
    scale = max(want[name].abs().max().item(), floor)
    err = (p.grad - want[name]).abs().max().item()
    assert err <= 1e-4 * scale, (name, err, scale)
