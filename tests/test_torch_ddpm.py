"""The port's DDPM net (`indm_torch/models/ddpm.py`) against the JAX
package's (`indm_tpu/models/ddpm.py`) at a tiny geometry (nf 16, 8x8),
weights carried by `indm_torch.convert` and perturbed (`score_nets.py`):
the output with GroupNorm through the per-group statistics and through
kernels 1 and 2's plain versions (interpret-mode Pallas on the JAX side),
its variants, the score function, one DDPM score-only step, the SAME
stride-2 down conv at an odd and an even side, and kernel 1's launches an
evaluation at the full width derived from the net.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import score_nets as sn
from indm_torch import configs as torch_configs
from indm_torch import sde as torch_sde
from indm_torch.models import ddpm as torch_ddpm
from indm_torch.models import layers as torch_layers
from indm_torch.models import registry as torch_registry
from indm_tpu import sde as jax_sde
from indm_tpu.models import get_model as jax_get_model
from indm_tpu.models import get_score_fn as jax_get_score_fn
from indm_tpu.models import layers as jax_layers
from score_nets import unoptimized_xla  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

DDPM = {"model.name": "ddpm", "model.nf": 16}
LABELS = np.array([10.0, 500.0], np.float32)


VARIANTS = {"model.resamp_with_conv": False, "model.nonlinearity": "elu",
            "model.conditional": False, "model.scale_by_sigma": True}


@functools.lru_cache(maxsize=None)
def variables_of(variants: bool):
  """The JAX net's perturbed variables, made once for the configs that
  share them (`model.fused_groupnorm` leaves the parameters as they
  are)."""
  jc, _ = sn.configs(**DDPM, **(VARIANTS if variants else {}))
  return sn.jax_net(jc)[1]


@pytest.mark.parametrize("leaves", [
    {}, {"model.fused_groupnorm": True},
    # legacy flavour: no resampling conv (average pool, nearest only), elu,
    # unconditional, the output divided by sigma of the integer labels
    VARIANTS], ids=["plain", "fused_groupnorm", "variants"])
def test_ddpm_matches_jax(leaves):
  jc, tc = sn.configs(**DDPM, **leaves)
  variables = variables_of(leaves is VARIANTS)
  module = jax_get_model("ddpm")(jc)
  model = sn.port_net(tc, variables)
  sn.compare_nets(module, variables, model, sn.images(2, 8), LABELS)


def test_ddpm_score_fn_matches_jax():
  jc, tc = sn.configs(**DDPM)
  variables = variables_of(False)
  module = jax_get_model("ddpm")(jc)
  model = sn.port_net(tc, variables)
  j_fn = jax_get_score_fn(jc, jax_sde.get_sde(jc), module, variables,
                          continuous=True)
  t_fn = torch_registry.get_score_fn(tc, torch_sde.get_sde(tc), model)
  sn.compare_score_fns(j_fn, t_fn, 8)


def test_ddpm_score_step_matches_jax(monkeypatch):
  """The DDPM loss (`training.continuous=False`), dropout off, at nf 64:
  with min(32, C) groups a net of 32 channels or fewer has one channel a
  group, and every bias before a GroupNorm gets a gradient of exactly 0,
  which both packages compute as rounding noise."""
  jc, tc = sn.configs(**{**DDPM, "model.nf": 64}, **{"model.dropout": 0.0,
                                 "training.continuous": False,
                                 "training.likelihood_weighting": False,
                                 "training.importance_sampling": False,
                                 "flow.model": "identity"})
  module, variables = sn.jax_net(jc)
  sn.step_against_jax(jc, tc, module, variables, monkeypatch)


@pytest.mark.parametrize("size", [7, 8])
def test_down_conv_pads_as_xla_same(size):
  """`conv3x3(stride=2)` with SAME pads (0, 1) on an even side, (1, 1) on
  an odd one (`ddpm.py:104-110`)."""
  x = sn.images(2, size, seed=3)
  conv = jax_layers.conv3x3(3, stride=2)
  variables = sn.perturbed(conv.init(jax.random.PRNGKey(0), x))
  want = np.asarray(conv.apply(variables, x))
  mod = torch_ddpm.Downsample(3)
  p = variables["params"]
  mod.Conv_0.weight.data = torch.from_numpy(np.transpose(
      np.asarray(p["kernel"]), (3, 2, 0, 1)).copy())
  mod.Conv_0.bias.data = torch.from_numpy(np.array(p["bias"]))
  with torch.no_grad():
    got = sn.nhwc(mod(sn.nchw(x)))
  assert got.shape == want.shape == (2, (size + 1) // 2, (size + 1) // 2, 3)
  sn.assert_close(got, want, 1e-6)


def test_kernel_1_launches_an_evaluation_at_full_width():
  """Ho et al.'s CIFAR-10 net (nf 128, ch_mult (1,2,2,2), two res blocks,
  attention at 16): 49 GroupNorms, each one launch of kernel 1 an
  evaluation (16 + 2 down, 5 in the middle, 24 + 1 up, 1 out), each of 32
  groups (rows of C / 32 channels: 4 to 16 here)."""
  c = torch_configs.get_config("vp/CIFAR10/indm_nll")
  c.model.name, c.model.num_res_blocks = "ddpm", 2
  c.model.fused_groupnorm = True
  net = torch_ddpm.DDPM(c, device="meta")
  norms = [m for m in net.modules() if isinstance(m, torch_layers.GroupNorm)]
  assert len(norms) == 49 and all(m.fused for m in norms)
  assert {m.num_groups for m in norms} == {32}
  assert {m.weight.shape[0] // 32 for m in norms} == {4, 8, 12, 16}
