"""Score-model construction, the model function and the score-function
wrapper.

Counterpart of `indm_tpu/models/registry.py:41-145`: every registered net
(`MODELS`) under the four SDEs, continuous and discrete, and the DDPM beta
tables.
"""

from __future__ import annotations

import numpy as np
import torch

from indm_torch import sde as sde_lib


def get_sigmas(config) -> np.ndarray:
  """Descending SMLD noise levels."""
  return np.exp(np.linspace(np.log(config.model.sigma_max),
                            np.log(config.model.sigma_min),
                            config.model.num_scales)).astype(np.float32)


def get_ddpm_params(config) -> dict:
  """The DDPM beta tables (`indm_tpu/models/registry.py:48-66`), float64
  numpy arrays over 1000 steps."""
  n = 1000
  beta_start = config.model.beta_min / config.model.num_scales
  beta_end = config.model.beta_max / config.model.num_scales
  betas = np.linspace(beta_start, beta_end, n, dtype=np.float64)
  alphas = 1.0 - betas
  alphas_cumprod = np.cumprod(alphas, axis=0)
  return {"betas": betas, "alphas": alphas, "alphas_cumprod": alphas_cumprod,
          "sqrt_alphas_cumprod": np.sqrt(alphas_cumprod),
          "sqrt_1m_alphas_cumprod": np.sqrt(1.0 - alphas_cumprod),
          "beta_min": beta_start * (n - 1), "beta_max": beta_end * (n - 1),
          "num_diffusion_timesteps": n}


def model_classes() -> dict:
  """`model.name` -> the net's class, the JAX package's registry
  (`indm_tpu/models/__init__.py:13-16`)."""
  from indm_torch.models import ddpm, ncsnpp, ncsnv2, vdm
  return {"ncsnpp": ncsnpp.NCSNpp, "ddpm": ddpm.DDPM,
          "ncsnv2_64": ncsnv2.NCSNv2, "ncsnv2_128": ncsnv2.NCSNv2_128,
          "ncsnv2_256": ncsnv2.NCSNv2_256, "ncsn": ncsnv2.NCSN,
          "vdm": vdm.VDM}


def create_model(config, seed: int = 0, device="cuda") -> torch.nn.Module:
  """The net `model.name` in eval mode with weights drawn from `seed` (on
  the CPU, so that they do not depend on the device), then moved to
  `device`."""
  classes = model_classes()
  if config.model.name not in classes:
    raise KeyError(f"no model registered as {config.model.name!r}; one of "
                   f"{sorted(classes)}")
  if config.model.name == "ncsn" and config.model.normalization == "BatchNorm":
    raise ValueError(
        "ncsn with model.normalization=BatchNorm: its conditional BatchNorm "
        "moves the running statistics in every call, which the JAX "
        "package's model function does not allow (flax's "
        "ModifyScopeVariableError), so no entry point runs it")
  gen = torch.Generator().manual_seed(seed)
  return classes[config.model.name](config, generator=gen).to(device).eval()


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
                 differentiable: bool = False, gamma_t=None):
  """score_fn(x, t, generator=None), the branches of
  `indm_tpu/models/registry.py:98-140` (`continuous` defaults to
  `config.training.continuous`):

  - VP, GeometricVP (a VPSDE) and subVP: with `continuous`, or always
    under subVP, the labels t * 999, or under
    `training.unbounded_parametrization` 999 (A(t) - A(1e-5)) / (A(T) -
    A(1e-5)) of the SDE's antiderivative A at `training.stabilizing_constant`,
    or for `model.name='vdm'` the labels `gamma_t`, and std from
    `marginal_prob` (subVP's is its variance-like value);
    otherwise the discrete labels t * (N - 1) and std
    `sqrt_1m_alphas_cumprod` at their truncation. With `training.ddpm_score`
    the score is -net / std.
  - VE: with `continuous` the net takes sigma(t) (and divides by it);
    otherwise the labels round((T - t) (N - 1)) as integers.

  `train`, `differentiable` and `generator` as in `get_model_fn`. No caller
  passes `gamma_t`, in either package (`indm_tpu/run_lib.py:97-101`): the
  VDM net's continuous VP labels are then None, on which the JAX net fails
  (`None.astype`), and this one raises."""
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
      elif config.model.name == "vdm":
        if gamma_t is None:
          raise ValueError(
              "the VDM net takes gamma(t) labels, which no caller passes "
              "(gamma_t is None; the JAX package fails there too)")
        labels = gamma_t
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
