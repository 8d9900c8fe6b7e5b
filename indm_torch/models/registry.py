"""Score-model construction and the score-function wrapper.

Counterpart of `indm_tpu/models/registry.py:41-145` for NCSN++ under the
continuous VP and VE SDEs.
"""

from __future__ import annotations

import numpy as np
import torch

from indm_torch import sde as sde_lib
from indm_torch.models.ncsnpp import NCSNpp


def get_sigmas(config) -> np.ndarray:
  """Descending SMLD noise levels."""
  return np.exp(np.linspace(np.log(config.model.sigma_max),
                            np.log(config.model.sigma_min),
                            config.model.num_scales)).astype(np.float32)


def create_model(config, seed: int = 0, device="cuda") -> NCSNpp:
  """NCSN++ in eval mode with weights drawn from `seed` (on the CPU, so that
  they do not depend on the device), then moved to `device`."""
  if config.model.name != "ncsnpp":
    raise NotImplementedError(f"model {config.model.name} is not ported yet")
  gen = torch.Generator().manual_seed(seed)
  return NCSNpp(config, generator=gen).to(device).eval()


def get_score_fn(config, sde, model, continuous: bool = True,
                 train: bool = False):
  """score_fn(x, t, generator=None). Under the VP SDE the net takes the
  labels t * 999 and score = -net / std; under the VE SDE it takes
  sigma(t) and its output is the score (the net divides by sigma). With
  `train` the net runs with autograd on and its dropout masks drawn from
  `generator` (the caller puts the model in train mode); otherwise under
  no_grad."""
  if not continuous or config.training.unbounded_parametrization:
    raise NotImplementedError("only the continuous VP and VE scores are "
                              "ported")
  grad = lambda: torch.set_grad_enabled(train and torch.is_grad_enabled())

  if isinstance(sde, sde_lib.VESDE):
    def score_fn(x, t, generator=None):
      with grad():
        return model(x, sde.marginal_prob(x, t)[1], generator)
    return score_fn

  if not isinstance(sde, sde_lib.VPSDE):
    raise NotImplementedError(f"{type(sde).__name__} is not ported yet")

  def score_fn(x, t, generator=None):
    with grad():
      score = model(x, t * 999, generator)
    std = sde.marginal_prob(torch.zeros_like(x), t)[1]
    if config.training.ddpm_score:
      score = -score / sde_lib.right_bcast(std, x)
    return score

  return score_fn
