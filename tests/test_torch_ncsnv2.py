"""The port's RefineNet score nets and normalization zoo
(`indm_torch/models/ncsnv2.py`, `normalization.py`) against the JAX
package's: `ncsnv2_64` at 16 and 28 pixels (28 sets `adjust_padding`),
`ncsnv2_128` and `ncsnv2_256` at 16, the class-conditional `ncsn` with two
label sets, every normalization and its conditional version alone (the
conditional BatchNorm's batch statistics and running ones), the blocks
where XLA's padding, pooling and resizing decide, the score function and
one SMLD score-only step. Weights carried by `indm_torch.convert` and
perturbed (`score_nets.py`); outputs within 5e-5 of their largest value.
"""

import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import score_nets as sn
from indm_torch import convert
from indm_torch import sde as torch_sde
from indm_torch.models import ncsnv2 as torch_v2
from indm_torch.models import normalization as torch_norm
from indm_torch.models import registry as torch_registry
from indm_tpu import sde as jax_sde
from indm_tpu.models import get_score_fn as jax_get_score_fn
from indm_tpu.models import ncsnv2 as jax_v2
from indm_tpu.models import normalization as jax_norm
from score_nets import unoptimized_xla  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

V2 = {"model.nf": 16, "model.normalization": "InstanceNorm++",
      "model.nonlinearity": "elu", "training.continuous": False,
      "model.num_scales": 20}
LABELS = np.array([2, 17], np.int32)
LABELS_B = np.array([9, 0], np.int32)


def v2_configs(**leaves):
  return sn.configs("ve/CIFAR10/indm", **{**V2, **leaves})


# the leaves of the SMLD score-only step, which leave the net as it is
STEP = {"training.likelihood_weighting": False,
        "training.importance_sampling": False, "model.dropout": 0.0,
        "flow.model": "identity"}


@functools.lru_cache(maxsize=None)
def net(name, size):
  """(JAX config, port config, JAX module, variables, port net), made once
  a module for the tests that share them."""
  jc, tc = v2_configs(**{"model.name": name, "data.image_size": size,
                         **STEP})
  module, variables = sn.jax_net(jc)
  return jc, tc, module, variables, sn.port_net(tc, variables)


@pytest.mark.parametrize("name,size", [("ncsnv2_64", 16), ("ncsnv2_64", 28),
                                       ("ncsnv2_128", 16),
                                       ("ncsnv2_256", 16)])
def test_net_matches_jax(name, size):
  _, _, module, variables, model = net(name, size)
  sn.compare_nets(module, variables, model, sn.images(2, size), LABELS)


def test_ncsn_matches_jax_at_two_label_sets():
  jc, tc = v2_configs(**{"model.name": "ncsn", "data.image_size": 16,
                         "model.num_classes": 20})
  module, variables = sn.jax_net(jc)
  model = sn.port_net(tc, variables)
  x = sn.images(2, 16)
  for labels in (LABELS, LABELS_B):
    sn.compare_nets(module, variables, model, x, labels)


def test_ncsn_batchnorm_as_the_jax_net_calls_it():
  """The JAX NCSN calls its conditional BatchNorm with train=True: apply
  fails unless `batch_stats` is mutable, so no entry point of the JAX
  package runs it, and `create_model` refuses it here. The port's net, as
  the JAX net with mutable statistics: the output and the moved running
  statistics."""
  jc, tc = v2_configs(**{"model.name": "ncsn", "data.image_size": 16,
                         "model.num_classes": 20,
                         "model.normalization": "BatchNorm"})
  module, variables = sn.jax_net(jc)
  x = jnp.asarray(sn.images(2, 16))
  with pytest.raises(flax.errors.ModifyScopeVariableError):
    module.apply(variables, x, jnp.asarray(LABELS), train=False)
  with pytest.raises(ValueError, match="BatchNorm"):
    torch_registry.create_model(tc, device="cpu")
  want, updated = module.apply(variables, x, jnp.asarray(LABELS),
                               train=False, mutable=["batch_stats"])
  model = sn.port_net(tc, variables)
  with torch.no_grad():
    got = sn.nhwc(model(sn.nchw(np.asarray(x)), torch.from_numpy(LABELS)))
  sn.assert_close(got, np.asarray(want))
  stats = convert.score_state_dict_from_jax(
      sn.np_tree(variables["params"]), tc, None,
      sn.np_tree(updated["batch_stats"]))
  for k, v in model.state_dict().items():
    if k.endswith(("running_mean", "running_var")):
      torch.testing.assert_close(v, stats[k], rtol=1e-5, atol=1e-6)


def _norm_pair(jax_mod, port_mod, x, *extra, mutable=False):
  variables = sn.perturbed(jax_mod.init(jax.random.PRNGKey(0), x, *extra))
  out = jax_mod.apply(variables, x, *extra,
                      mutable=["batch_stats"] if mutable else False)
  sd = convert._refinenet_module(port_mod, sn.np_tree(
      variables.get("params", {})), sn.np_tree(variables.get("batch_stats")))
  port_mod.load_state_dict(sd, strict=True)
  return variables, out


@pytest.mark.parametrize("name", ["InstanceNorm", "InstanceNorm++",
                                  "VarianceNorm", "NoneNorm", "GroupNorm"])
def test_normalization_matches_jax(name):
  c = 32 if name == "GroupNorm" else 6
  x = sn.images(2, 5, seed=3)
  x = np.concatenate([x] * (c // 3 + 1), axis=-1)[..., :c] * np.arange(
      1, c + 1)
  jc, tc = v2_configs(**{"model.normalization": name})
  port = torch_norm.get_normalization(tc)(c)
  _, want = _norm_pair(jax_norm.get_normalization(jc)(), port, x)
  with torch.no_grad():
    sn.assert_close(sn.nhwc(port(sn.nchw(x))), np.asarray(want), 1e-6)


@pytest.mark.parametrize("name", ["InstanceNorm++", "InstanceNorm",
                                  "VarianceNorm", "NoneNorm", "BatchNorm"])
@pytest.mark.parametrize("bias", [True, False])
def test_conditional_normalization_matches_jax(name, bias):
  """At two label sets; the conditional BatchNorm with the batch's
  statistics (the moved running ones too) and with the running ones."""
  c = 6
  x = sn.images(3, 5, seed=4)
  x = np.concatenate([x, 2 * x + 1], axis=-1)
  jc, tc = v2_configs(**{"model.normalization": name,
                         "model.num_classes": 10})
  j_cls = jax_norm.get_normalization(jc, conditional=True)
  port = torch_norm.get_normalization(tc, conditional=True)(c, bias=bias)
  j_mod = j_cls(bias=bias)
  bn = name == "BatchNorm"
  for labels in (np.array([1, 7, 7]), np.array([0, 9, 3])):
    variables, out = _norm_pair(j_mod, port, x, labels, mutable=bn)
    with torch.no_grad():
      got = port(sn.nchw(x), torch.from_numpy(labels))
    if bn:
      out, updated = out
      moved = convert._refinenet_module(
          port, sn.np_tree(variables["params"]),
          sn.np_tree(updated["batch_stats"]))
      for k in ("bn.running_mean", "bn.running_var"):
        torch.testing.assert_close(port.state_dict()[k], moved[k],
                                   rtol=1e-6, atol=1e-7)
      eval_out = j_mod.apply({**variables, **updated}, x, labels,
                             train=False)
      with torch.no_grad():
        sn.assert_close(sn.nhwc(port(sn.nchw(x), torch.from_numpy(labels),
                                     train=False)),
                        np.asarray(eval_out), 1e-6)
    sn.assert_close(sn.nhwc(got), np.asarray(out), 1e-6)


def test_conv_mean_pool_adjust_padding_matches_jax():
  """`adjust_padding` pads (1, 0) before the SAME conv: a 7-pixel side
  pools to 4 (`ncsnv2.py:45-46`); the nets never take it (the dilated
  blocks ignore it, in both packages)."""
  x = sn.images(2, 7, seed=5)
  j_mod = jax_v2.ConvMeanPool(4, 3, adjust_padding=True)
  port = torch_v2.ConvMeanPool(3, 4, 3, adjust_padding=True)
  _, want = _norm_pair(j_mod, port, x)
  with torch.no_grad():
    got = sn.nhwc(port(sn.nchw(x)))
  assert got.shape == (2, 4, 4, 4)
  sn.assert_close(got, np.asarray(want), 1e-6)


@pytest.mark.parametrize("maxpool", [True, False])
def test_crp_block_pools_as_flax(maxpool):
  """Max pooling pads with -inf, average pooling divides by 25 pads
  included; on values all below 0, so that a zero pad would show."""
  x = -np.abs(sn.images(2, 6, seed=6)) - 1.0
  j_mod = jax_v2.CRPBlock(3, 2, jax.nn.elu, maxpool=maxpool)
  port = torch_v2.CRPBlock(3, 2, torch.nn.functional.elu, maxpool=maxpool)
  _, want = _norm_pair(j_mod, port, x)
  with torch.no_grad():
    sn.assert_close(sn.nhwc(port(sn.nchw(x))), np.asarray(want), 1e-6)


@pytest.mark.parametrize("src,dst", [(4, 8), (8, 8), (5, 9), (9, 4),
                                     (8, 3)])
def test_resize_matches_jax_image_resize(src, dst):
  """`jax.image.resize(..., "bilinear")` both ways: half-pixel centres,
  antialiased where it shrinks (where `F.interpolate` is not)."""
  x = sn.images(2, src, seed=7)
  want = np.asarray(jax.image.resize(jnp.asarray(x), (2, dst, dst, 3),
                                     "bilinear"))
  got = sn.nhwc(torch_v2.resize_bilinear(sn.nchw(x), (dst, dst)))
  sn.assert_close(got, want, 1e-6)


def test_get_network_dispatches_as_jax():
  for size in (28, 32, 64, 96, 128, 200, 256):
    jc, tc = v2_configs(**{"data.image_size": size})
    assert (jax_v2.get_network(jc).func.__name__
            == torch_v2.get_network(tc).__name__)
  with pytest.raises(NotImplementedError):
    torch_v2.get_network(v2_configs(**{"data.image_size": 512})[1])


def test_score_fn_matches_jax():
  """VE's discrete labels round((T - t)(N - 1)), then the net's division by
  their sigma."""
  jc, tc, module, variables, model = net("ncsnv2_64", 16)
  j_fn = jax_get_score_fn(jc, jax_sde.get_sde(jc), module, variables,
                          continuous=False)
  t_fn = torch_registry.get_score_fn(tc, torch_sde.get_sde(tc), model)
  sn.compare_score_fns(j_fn, t_fn, 16)


def test_smld_score_step_matches_jax(monkeypatch):
  jc, tc, module, variables, _ = net("ncsnv2_64", 16)
  sn.step_against_jax(jc, tc, module, variables, monkeypatch)
