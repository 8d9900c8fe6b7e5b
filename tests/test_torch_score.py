"""The port's NCSN++ score function against the JAX package, with the JAX
weights carried over by `indm_torch.convert`, and the weight round trip
through the JAX package's own converter.

The geometry is the tiny one of `tests/test_golden.py` with
`model.init_scale = 1.0`: at the VP default of 0 the last conv of every
block starts at ~1e-10 and the net is nearly a chain of skips, which would
make the comparison say nothing about the blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indm_torch import configs as torch_configs
from indm_torch import convert
from indm_torch import sde as torch_sde
from indm_torch.models import registry as torch_registry
from indm_torch.models.ncsnpp import NCSNpp
from indm_torch.ops import group_norm as gn
from indm_tpu import configs as jax_configs
from indm_tpu import sde as jax_sde
from indm_tpu.models import create_model as jax_create_model
from indm_tpu.models import get_score_fn as jax_get_score_fn
from indm_tpu.models.convert import ncsnpp_params_from_torch
from torch_threads import one_torch_thread  # noqa: F401

TINY = {"data.image_size": 8, "model.nf": 8, "model.num_res_blocks": 1,
        "model.ch_mult": (1, 1), "model.attn_resolutions": (4,),
        "model.init_scale": 1.0}


def _set(cfg, name, value):
  *path, leaf = name.split(".")
  node = cfg
  for p in path:
    node = getattr(node, p)
  setattr(node, leaf, value)


def tiny_configs(**extra):
  jc = jax_configs.get_config("vp/CIFAR10/indm_nll")
  tc = torch_configs.get_config("vp/CIFAR10/indm_nll")
  for k, v in {**TINY, **extra}.items():
    _set(jc, k, v)
    _set(tc, k, v)
  return jc, tc


def _np_tree(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_model():
  jc, _ = tiny_configs()
  module, variables = jax_create_model(jc, jax.random.PRNGKey(0))
  return module, variables


@pytest.mark.parametrize("fused", [False, True])
def test_score_fn_matches_jax(jax_model, fused):
  """Scores at several t, GroupNorm through the kernel path (`fused`, the
  plain version on the CPU; interpret-mode Pallas on the JAX side) or
  through the per-group statistics. The JAX GroupNorm folds
  per-(sample, channel) moments into groups, so sums run in another
  order; the tolerance is the JAX package's own fused-vs-plain NCSN++
  parity (5e-5), relative to the largest score."""
  module, variables = jax_model
  jc, tc = tiny_configs(**{"model.fused_groupnorm": fused})
  module = type(module)(jc)
  sd = convert.score_state_dict_from_jax(_np_tree(variables["params"]), tc)
  model = NCSNpp(tc)
  model.load_state_dict(sd, strict=True)
  model.eval()
  j_sde, t_sde = jax_sde.get_sde(jc), torch_sde.get_sde(tc)
  j_score = jax.jit(jax_get_score_fn(jc, j_sde, module, variables,
                                     train=False, continuous=True))
  t_score = torch_registry.get_score_fn(tc, t_sde, model)
  x = np.random.default_rng(0).normal(size=(4, 8, 8, 3)).astype(np.float32)
  gn.reset_launches()
  for tval in (1e-3, 0.1, 0.5, 1.0):
    t = np.full((4,), tval, np.float32)
    s_j = np.asarray(j_score(jnp.asarray(x), jnp.asarray(t)))
    s_t = t_score(torch.from_numpy(x).permute(0, 3, 1, 2),
                  torch.from_numpy(t)).permute(0, 2, 3, 1).numpy()
    scale = np.abs(s_j).max()
    assert scale > 1.0  # the net's output is not degenerate
    np.testing.assert_allclose(s_t / scale, s_j / scale, atol=5e-5)
  assert gn.launches == 0


def test_score_weights_round_trip(jax_model):
  """JAX params -> port state_dict -> the JAX package's torch converter ->
  the same JAX params, and the port's own initial state_dict survives the
  way back."""
  _, variables = jax_model
  jc, tc = tiny_configs()
  params = _np_tree(variables["params"])
  sd = convert.score_state_dict_from_jax(params, tc)
  back, buffers = ncsnpp_params_from_torch(sd, jc)
  assert not buffers
  flat_a = jax.tree_util.tree_leaves_with_path(params)
  flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
  assert len(flat_a) == len(flat_b)
  for path, leaf in flat_a:
    np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf)

  model = torch_registry.create_model(tc, seed=3, device="cpu")
  ours = model.state_dict()
  jax_params, _ = ncsnpp_params_from_torch(ours, jc)
  again = convert.score_state_dict_from_jax(_np_tree(jax_params), tc)
  assert set(again) == set(ours)
  for k, v in ours.items():
    torch.testing.assert_close(again[k], v, atol=0, rtol=0)
