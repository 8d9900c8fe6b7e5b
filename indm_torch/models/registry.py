"""Score-model construction, the model function and the score-function
wrapper.

Counterpart of `indm_tpu/models/registry.py:41-145` for NCSN++ under the
four SDEs, continuous and discrete.
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


def get_model_fn(model, train: bool = False, differentiable: bool = False):
  """model_fn(x, labels, generator=None): the net's raw output at
  `labels`, the function the discrete (SMLD and DDPM) losses call. With
  `train` autograd is on and the dropout masks come from `generator` (the
  caller puts the model in train mode); with `differentiable` autograd
  stays on in eval mode; otherwise the net runs under no_grad."""

  def model_fn(x, labels, generator=None):
    with torch.set_grad_enabled((train or differentiable)
                                and torch.is_grad_enabled()):
      return model(x, labels, generator)

  return model_fn


def get_score_fn(config, sde, model, continuous=None, train: bool = False,
                 differentiable: bool = False):
  """score_fn(x, t, generator=None), the branches of
  `indm_tpu/models/registry.py:98-140` (`continuous` defaults to
  `config.training.continuous`):

  - VP, GeometricVP (a VPSDE) and subVP: with `continuous`, or always
    under subVP, the labels t * 999, or under
    `training.unbounded_parametrization` 999 (A(t) - A(1e-5)) / (A(T) -
    A(1e-5)) of the SDE's antiderivative A at `training.stabilizing_constant`,
    and std from `marginal_prob` (subVP's is its variance-like value);
    otherwise the discrete labels t * (N - 1) and std
    `sqrt_1m_alphas_cumprod` at their truncation. With `training.ddpm_score`
    the score is -net / std.
  - VE: with `continuous` the net takes sigma(t) (and divides by it);
    otherwise the labels round((T - t) (N - 1)) as integers.

  `train`, `differentiable` and `generator` as in `get_model_fn`."""
  if continuous is None:
    continuous = config.training.continuous
  model_fn = get_model_fn(model, train, differentiable)

  if isinstance(sde, sde_lib.VESDE):
    def score_fn(x, t, generator=None):
      if continuous:
        labels = sde.marginal_prob(x, t)[1]
      else:
        labels = torch.round((sde.T - t) * (sde.N - 1)).to(torch.int32)
      return model_fn(x, labels, generator)
    return score_fn

  if not isinstance(sde, (sde_lib.VPSDE, sde_lib.subVPSDE)):
    raise NotImplementedError(
        f"SDE class {type(sde).__name__} not yet supported.")

  def score_fn(x, t, generator=None):
    if continuous or isinstance(sde, sde_lib.subVPSDE):
      if config.training.unbounded_parametrization:
        if not hasattr(sde, "antiderivative"):
          raise NotImplementedError(
              "training.unbounded_parametrization needs the SDE's "
              f"antiderivative, which {type(sde).__name__} lacks (the JAX "
              "package fails there too)")
        c = config.training.stabilizing_constant
        a_min = sde.antiderivative(1e-5, c)
        labels = ((sde.antiderivative(t, c) - a_min.to(t.device))
                  / (sde.antiderivative(sde.T, c) - a_min).to(t.device)
                  * 999.0)
      else:
        labels = t * 999
      score = model_fn(x, labels, generator)
      std = sde.marginal_prob(torch.zeros_like(x), t)[1]
    else:
      labels = t * (sde.N - 1)
      score = model_fn(x, labels, generator)
      std = sde.sqrt_1m_alphas_cumprod.to(x.device)[labels.long()]
    if config.training.ddpm_score:
      score = -score / sde_lib.right_bcast(std, x)
    return score

  return score_fn
