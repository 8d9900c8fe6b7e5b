"""VP SDE and its reverse-time SDE/ODE (PyTorch).

Counterpart of `indm_tpu/sde.py:27-200, 393-410`. Tensors keep a leading
batch dimension; t has shape [B]; drift has the shape of x; diffusion and
std have shape [B]. Random draws take an explicit `torch.Generator`, or the
noise itself.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def right_bcast(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
  """Reshape a [B] vector so it broadcasts against x of shape [B, ...]."""
  return v.reshape(v.shape[0], *([1] * (x.dim() - 1)))


class SDE:

  def __init__(self, N: int):
    self.N = N

  @property
  def T(self) -> float:
    return 1.0

  def sde(self, x, t):
    raise NotImplementedError

  def marginal_prob(self, x, t):
    raise NotImplementedError

  def discretize(self, x, t, next_t=None):
    raise NotImplementedError

  def reverse(self, score_fn, probability_flow: bool = False):
    """The reverse-time SDE, or with `probability_flow` the ODE."""
    fwd = self
    coef = 0.5 if probability_flow else 1.0

    class RSDE:
      N = fwd.N
      T = fwd.T

      def sde(self, x, t):
        drift, diffusion = fwd.sde(x, t)
        score = score_fn(x, t)
        drift = drift - right_bcast(diffusion, x) ** 2 * score * coef
        if probability_flow:
          diffusion = torch.zeros_like(diffusion)
        return drift, diffusion

      def discretize(self, x, t, next_t=None):
        if next_t is None:
          f, G = fwd.discretize(x, t, None)
        else:
          # where next_t reaches 0, the continuous diffusion coefficient
          f_pos, G_pos = fwd.discretize(x, t, next_t)
          _, diffusion = fwd.sde(x, t)
          G_zero = diffusion * torch.sqrt(torch.clamp(t - next_t, min=0.0))
          pos = next_t > 0
          f = torch.where(right_bcast(pos, x), f_pos, torch.zeros_like(x))
          G = torch.where(pos, G_pos, G_zero)
        rev_f = f - right_bcast(G, x) ** 2 * score_fn(x, t) * coef
        rev_G = torch.zeros_like(G) if probability_flow else G
        return rev_f, rev_G

    return RSDE()


class VPSDE(SDE):
  """Variance-preserving SDE."""

  def __init__(self, truncation_time=1e-5, beta_min=0.1, beta_max=20,
               N=1000):
    super().__init__(N)
    self.beta_0 = float(beta_min)
    self.beta_1 = float(beta_max)
    self.eps = float(truncation_time)
    betas = np.linspace(beta_min / N, beta_max / N, N, dtype=np.float64)
    self.discrete_betas = torch.tensor(betas, dtype=torch.float32)
    self.alphas = torch.tensor(1.0 - betas, dtype=torch.float32)

  def _beta_t(self, t):
    return self.beta_0 + t * (self.beta_1 - self.beta_0)

  def sde(self, x, t):
    beta_t = self._beta_t(t)
    drift = -0.5 * right_bcast(beta_t, x) * x
    return drift, torch.sqrt(beta_t)

  def marginal_prob(self, x, t):
    log_mean_coeff = (-0.25 * t ** 2 * (self.beta_1 - self.beta_0)
                      - 0.5 * t * self.beta_0)
    mean = torch.exp(right_bcast(log_mean_coeff, x)) * x
    std = torch.sqrt(1.0 - torch.exp(2.0 * log_mean_coeff))
    return mean, std

  def prior_sampling(self, shape, generator: Optional[torch.Generator] = None,
                     device="cuda", noise: Optional[torch.Tensor] = None):
    """z ~ N(0, I) of `shape`; `noise` replaces the draw."""
    if noise is None:
      noise = torch.randn(shape, generator=generator, device=device)
    return noise.to(device=device, dtype=torch.float32)

  def discretize(self, x, t, next_t=None):
    """DDPM discretization."""
    if next_t is None:
      timestep = (t * (self.N - 1) / self.T).long()
      beta = self.discrete_betas.to(x.device)[timestep]
      alpha = self.alphas.to(x.device)[timestep]
      f = right_bcast(torch.sqrt(alpha), x) * x - x
      G = torch.sqrt(beta)
    else:
      G = torch.sqrt(torch.clamp((t - next_t) * self._beta_t(t), min=0.0))
      f = right_bcast(torch.sqrt(1.0 - G ** 2), x) * x - x
    return f, G


def get_sde(config) -> SDE:
  name = config.training.sde.lower()
  if name == "vpsde":
    return VPSDE(truncation_time=config.training.truncation_time,
                 beta_min=config.model.beta_min,
                 beta_max=config.model.beta_max, N=config.model.num_scales)
  raise NotImplementedError(f"SDE {config.training.sde} is not ported yet.")
