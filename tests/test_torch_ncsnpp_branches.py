"""Every branch of the JAX NCSN++ net in the port: the outputs against the
JAX package's at the tiny geometry (weights carried by
`indm_torch.convert`, perturbed as `score_nets.py` says), and the port's
state_dict back through the JAX package's own converter
(`indm_tpu/models/convert.py:ncsnpp_params_from_torch`) to the same JAX
output; the layers new to the port against their JAX modules, at an even
and an odd side where padding decides; `check_supported` against the JAX
net's asserts. GroupNorm through the per-group statistics; the fused
kernels' plain versions are held in `tests/test_torch_score.py` and
`test_torch_group_norm.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import score_nets as sn
from indm_torch import convert
from indm_torch import sde as torch_sde
from indm_torch.models import layers as torch_layers
from indm_torch.models import registry as torch_registry
from indm_tpu import sde as jax_sde
from indm_tpu.models import create_model as jax_create_model
from indm_tpu.models import get_score_fn as jax_get_score_fn
from indm_tpu.models import layers as jax_layers
from indm_tpu.models.convert import ncsnpp_params_from_torch
from score_nets import unoptimized_xla  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

VP = np.array([10.0, 500.0], np.float32)   # t * 999
SMLD = np.array([3, 900], np.int32)        # the SMLD levels' indices
# one case a branch of `indm_tpu/models/ncsnpp.py` (the VP NLL config
# otherwise: BigGAN blocks, positional embedding, no pyramids, swish)
BRANCHES = {
    "ddpm_blocks": {"model.resblock_type": "ddpm"},
    "ddpm_blocks_fir": {"model.resblock_type": "ddpm", "model.fir": True},
    "ddpm_blocks_no_resamp_conv": {"model.resblock_type": "ddpm",
                                   "model.resamp_with_conv": False},
    "output_skip": {"model.progressive": "output_skip"},
    "output_residual": {"model.progressive": "residual"},
    "input_skip": {"model.progressive_input": "input_skip"},
    "input_residual": {"model.progressive_input": "residual"},
    "combine_cat": {"model.progressive_input": "input_skip",
                    "model.progressive_combine": "cat"},
    # the 256-pixel VE configs' pyramids: FIR both ways
    "fir_pyramids": {"model.fir": True, "model.progressive": "output_skip",
                     "model.progressive_input": "input_skip"},
    "fourier_feature": {"model.fourier_feature": True},
    # no resampling at all: the level attention stays off, where the JAX
    # converter would place it by the nominal resolution
    "no_auxiliary_resblock": {"model.auxiliary_resblock": False,
                              "model.attention": False},
    "no_attention": {"model.attention": False},
    "unconditional": {"model.conditional": False},
    # discrete SMLD NCSN++: the positional net under VE divides by sigma
    "positional_smld": {"model.scale_by_sigma": True,
                        "training.continuous": False},
    "elu": {"model.nonlinearity": "elu"},
    "relu": {"model.nonlinearity": "relu"},
    "lrelu": {"model.nonlinearity": "lrelu"},
}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_branch_matches_jax(branch):
  """The net's output within 5e-5 of its largest value; the port's
  state_dict through `ncsnpp_params_from_torch` gives the JAX net the same
  output (an unconditional net's unused `Dense_0` rides along, as the
  reference keeps it)."""
  leaves = BRANCHES[branch]
  jc, _, module, variables, model = sn.nets(**leaves)
  labels = SMLD if "training.continuous" in leaves else VP
  x = sn.images(2, 8)
  want = sn.compare_nets(module, variables, model, x, labels)
  back, buffers = ncsnpp_params_from_torch(model.state_dict(), jc)
  assert not buffers
  again = module.apply({**variables, "params": back}, jnp.asarray(x),
                       jnp.asarray(labels), train=False)
  np.testing.assert_array_equal(np.asarray(again), want)


def test_no_auxiliary_resblock_keeps_one_resolution():
  """Without auxiliary res blocks the BigGAN net never resamples, so the
  JAX net places level attention by the shape it meets (every level at
  the image size here); the port follows it. (The JAX converter places it
  by the nominal resolution: no round trip.)"""
  _, _, module, variables, model = sn.nets(**{
      "model.auxiliary_resblock": False, "model.attn_resolutions": (8,)})
  sn.compare_nets(module, variables, model, sn.images(2, 8), VP)
  attn = [m for m in model.all_modules
          if isinstance(m, torch_layers.AttnBlockpp)]
  assert len(attn) == 5  # 2 levels x 2 on the way, 1 up a level, middle


@pytest.mark.parametrize("leaves,error", [
    ({"model.progressive": "skip"}, AssertionError),
    ({"model.progressive_input": "skip"}, AssertionError),
    ({"model.resblock_type": "resnet"}, ValueError),
    ({"model.embedding_type": "fourier", "training.continuous": False},
     AssertionError)])
def test_check_supported_refuses_what_jax_asserts(leaves, error):
  jc, tc = sn.configs(**leaves)
  with pytest.raises(error):
    jax_create_model(jc, jax.random.PRNGKey(0))
  with pytest.raises(ValueError):
    torch_registry.create_model(tc, device="cpu")


@pytest.mark.parametrize("branch", ["positional_smld", "ddpm_blocks"])
def test_score_fn_matches_jax(branch):
  """`get_score_fn` on the VE discrete labels (positional SMLD) and the VP
  continuous ones (DDPM++ blocks), 5e-5 of the largest score."""
  leaves = dict(BRANCHES[branch])
  if branch == "positional_smld":
    leaves.update({"training.sde": "vesde", "model.num_scales": 50})
  jc, tc, module, variables, model = sn.nets(**leaves)
  cont = jc.training.continuous
  j_fn = jax_get_score_fn(jc, jax_sde.get_sde(jc), module, variables,
                          continuous=cont)
  t_fn = torch_registry.get_score_fn(tc, torch_sde.get_sde(tc), model)
  sn.compare_score_fns(j_fn, t_fn, 8)


def _jax_layer(layer, x):
  variables = layer.init(jax.random.PRNGKey(3), jnp.asarray(x))
  return sn.perturbed(variables), np.asarray(layer.apply(
      sn.perturbed(variables), jnp.asarray(x)))


def _conv_sd(p, prefix="Conv_0"):
  return {f"{prefix}.weight": torch.from_numpy(np.transpose(
              np.asarray(p["kernel"]), (3, 2, 0, 1)).copy()),
          f"{prefix}.bias": torch.from_numpy(np.array(p["bias"]))}


@pytest.mark.parametrize("size", [7, 8])
@pytest.mark.parametrize("with_conv", [True, False])
def test_plain_resampling_matches_jax(size, with_conv):
  """The non-FIR Downsample (zeros (0, 1), then a VALID stride-2 conv; or
  a 2x2 average) and Upsample (nearest, then a 3x3 conv) at an odd and an
  even side."""
  x = sn.images(2, size, seed=4)[..., :3]
  for jcls, tcls in ((jax_layers.Downsample, torch_layers.Downsample),
                     (jax_layers.Upsample, torch_layers.Upsample)):
    variables, want = _jax_layer(jcls(out_ch=5, with_conv=with_conv), x)
    mod = tcls(3, 5 if with_conv else None, with_conv=with_conv, fir=False)
    if with_conv:
      mod.load_state_dict(_conv_sd(variables["params"]["Conv_0"]))
    with torch.no_grad():
      got = sn.nhwc(mod(sn.nchw(x)))
    assert got.shape == want.shape
    sn.assert_close(got, want, 1e-6)


@pytest.mark.parametrize("method", ["cat", "sum"])
def test_combine_and_fourier_features_match_jax(method):
  x, y = sn.images(2, 8, seed=5), sn.images(2, 8, seed=6)
  layer = jax_layers.Combine(dim2=3, method=method)
  variables = sn.perturbed(layer.init(jax.random.PRNGKey(0), x, y))
  want = np.asarray(layer.apply(variables, x, y))
  mod = torch_layers.Combine(3, 3, method)
  mod.load_state_dict(_conv_sd(variables["params"]["Conv_0"]))
  with torch.no_grad():
    sn.assert_close(sn.nhwc(mod(sn.nchw(x), sn.nchw(y))), want, 1e-6)
  sn.assert_close(
      sn.nhwc(torch_layers.fixed_fourier_projection(sn.nchw(x))),
      np.asarray(jax_layers.fixed_fourier_projection(jnp.asarray(x))), 1e-5)


def test_activations_match_jax():
  x = sn.images(1, 8, seed=7) * 3
  for name in ("elu", "relu", "lrelu", "swish"):
    np.testing.assert_allclose(
        torch_layers.get_act(name)(torch.from_numpy(x)).numpy(),
        np.asarray(jax_layers.get_act(name)(jnp.asarray(x))), rtol=1e-6,
        atol=1e-6)
  with pytest.raises(NotImplementedError):
    torch_layers.get_act("gelu")


def test_fused_leaky_relu_matches_jax():
  """`ops/fused_act.py` (no Pallas kernel in either package), NCHW here and
  NHWC there, the function and the module."""
  from indm_torch.ops import fused_act as torch_fa
  from indm_tpu.ops import fused_act as jax_fa
  x = sn.images(2, 5, seed=9)
  bias = np.array([0.5, -1.0, 2.0], np.float32)
  want = np.asarray(jax_fa.fused_leaky_relu(jnp.asarray(x), jnp.asarray(bias),
                                            0.1, 1.5))
  got = torch_fa.fused_leaky_relu(sn.nchw(x), torch.from_numpy(bias), 0.1,
                                  1.5)
  np.testing.assert_allclose(sn.nhwc(got), want, rtol=1e-6, atol=1e-6)
  np.testing.assert_allclose(
      sn.nhwc(torch_fa.FusedLeakyReLU(3)(sn.nchw(x))),
      np.asarray(jax_fa.FusedLeakyReLU(3)(jnp.asarray(x))), rtol=1e-6,
      atol=1e-6)


def test_ddpmpp_block_conv_shortcut_matches_jax():
  """`ResnetBlockDDPMpp` with `conv_shortcut` (a 3x3 `Conv_2`; the JAX net
  never sets it) and `skip_rescale`."""
  x, temb = sn.images(2, 8, seed=8)[..., :3], np.ones((2, 16), np.float32)
  x = np.concatenate([x, x[..., :1]], axis=-1)  # 4 channels
  block = jax_layers.ResnetBlockDDPMpp(act=jax.nn.silu, out_ch=8,
                                       conv_shortcut=True, skip_rescale=True,
                                       init_scale=1.0)
  variables = sn.perturbed(block.init(jax.random.PRNGKey(0), x, temb,
                                      train=False))
  want = np.asarray(block.apply(variables, x, temb, train=False))
  mod = torch_layers.ResnetBlockDDPMpp(4, 8, temb_dim=16, conv_shortcut=True,
                                       skip_rescale=True, init_scale=1.0)
  mod.load_state_dict(convert._score_module(
      mod, sn.np_tree(variables["params"])))
  mod.eval()
  with torch.no_grad():
    got = sn.nhwc(mod(sn.nchw(x), torch.from_numpy(temb)))
  sn.assert_close(got, want)
