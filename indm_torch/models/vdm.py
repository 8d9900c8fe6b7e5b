"""VDM: NCSN++ on learned gamma(t) labels, and its trainable noise
schedule (PyTorch).

Counterpart of `indm_tpu/models/vdm.py`. The net is NCSN++ behind the two
asserts of the JAX module (:30-42): BigGAN blocks with
`auxiliary_resblock`, the only configuration the reference runs, and no
`scale_by_sigma`. Its state_dict is NCSN++'s (`all_modules.{i}.*`, the
reference VDM's keys; the JAX net nests the same tree as `backbone`).
`NoiseSchedule` is the JAX module (:45-54), its three Dense layers under
the JAX package's names (`Dense_0`-`Dense_2`: the reference's are not
known here); `get_gamma_fn` is `:57-69`.

As shipped, no caller passes gamma labels or trains the schedule, in
either package (`indm_tpu/run_lib.py:97-101`): `registry.get_score_fn`
raises on the VDM net's continuous VP labels, and `run_lib.load_vdm_aux`
keeps the schedule's state and checkpoint as the JAX loop keeps them.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from indm_torch.models.ncsnpp import NCSNpp


def check_supported(config) -> None:
  m = config.model
  if not (m.resblock_type.lower() == "biggan" and m.auxiliary_resblock):
    raise ValueError("VDM is supported for the biggan+auxiliary_resblock "
                     "configuration (the only one the reference runs).")
  if m.scale_by_sigma:
    raise ValueError("VDM has no scale_by_sigma output scaling.")


class VDM(NCSNpp):
  """NCSN++ taking gamma labels (positional embedding) or noise levels
  (Fourier embedding), after the VDM asserts."""

  def __init__(self, config, generator=None, device=None):
    check_supported(config)
    super().__init__(config, generator=generator, device=device)


def _lecun_dense(in_dim, out_dim, generator=None, device=None) -> nn.Linear:
  """flax `nn.Dense`'s init: the weight from a normal of variance 1 / fan_in
  truncated at two standard deviations (lecun_normal), a zero bias."""
  lin = nn.Linear(in_dim, out_dim, device=device)
  if device != "meta":
    std = 1.0 / math.sqrt(in_dim) / 0.87962566103423978
    with torch.no_grad():
      nn.init.trunc_normal_(lin.weight, 0.0, std, -2 * std, 2 * std,
                            generator=generator)
      lin.bias.zero_()
  return lin


class NoiseSchedule(nn.Module):
  """t -> gamma: d1(t) + d3(sigmoid(d2(d1(t)))), widths 1 -> 1024 -> 1."""

  def __init__(self, generator=None, device=None):
    super().__init__()
    kw = dict(generator=generator, device=device)
    self.Dense_0 = _lecun_dense(1, 1, **kw)
    self.Dense_1 = _lecun_dense(1, 1024, **kw)
    self.Dense_2 = _lecun_dense(1024, 1, **kw)

  def forward(self, t):
    d1 = self.Dense_0(t.reshape(-1, 1))
    h = torch.sigmoid(self.Dense_1(d1))
    return (d1 + self.Dense_2(h)).reshape(-1)


class VDMAux(nn.Module):
  """The VDM's extra state (`indm_tpu/run_lib.py:94-121`): `gamma`, the
  2-vector gamma_minmax (standard normal at init), and the schedule."""

  def __init__(self, generator=None, device=None):
    super().__init__()
    self.gamma = nn.Parameter(torch.empty(2, device=device))
    if device != "meta":
      with torch.no_grad():
        self.gamma.normal_(generator=generator)
    self.schedule = NoiseSchedule(generator=generator, device=device)


def get_gamma_fn(gamma_minmax, schedule: NoiseSchedule):
  """gamma_fn(t, detach=True): the schedule at t normalised to
  [gamma_minmax[0], gamma_minmax[1]] by its values at 0 and 1."""
  dev = gamma_minmax.device
  mn = schedule(torch.zeros(1, device=dev))
  mx = schedule(torch.ones(1, device=dev))

  def gamma_fn(t, detach: bool = True):
    g = schedule(t)
    if detach:
      g = g.detach()
    return (gamma_minmax[0] + (gamma_minmax[1] - gamma_minmax[0])
            * (g - mn) / (mx - mn))

  return gamma_fn

