"""VP and VE SDEs and their reverse-time SDE/ODE (PyTorch).

Counterpart of `indm_tpu/sde.py:27-202, 243-314, 393-410`. Tensors keep a
leading batch dimension; t has shape [B]; drift has the shape of x;
diffusion and std have shape [B]. Random draws take an explicit
`torch.Generator`, or the noise itself (the uniform draws `u`).
"""

from __future__ import annotations

from typing import Optional

import math

import numpy as np
import torch


def linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
  """`num` float32 points from start to stop by the arithmetic that
  `jnp.linspace` traces: s_i = f32(i) / f32(num - 1), then
  start * (1 - s_i) + stop * s_i, each operation rounded to float32, and
  the last point exactly stop. Built on the host, so the card and the CPU
  get the same bits (`torch.linspace` computes another way). XLA's CPU
  code may reassociate and contract this to fused multiply-adds, so the
  JAX grid can differ by one float32 step of 1.0 at large `num`; the SMLD
  predictor's truncated indices t * (N - 1) come out the same
  (`tests/test_torch_ve.py`)."""
  start, stop = np.float32(start), np.float32(stop)
  if num == 1:
    return np.array([start], np.float32)
  div = num - 1
  step = np.arange(div, dtype=np.float32) / np.float32(div)
  out = start * (np.float32(1) - step) + stop * step
  return np.concatenate([out, [stop]]).astype(np.float32)


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

  def get_t_min(self, st: bool = False, k: float = 1.0,
                generator: Optional[torch.Generator] = None, device="cuda",
                u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The smallest diffusion time, a float32 scalar: `eps`, or with soft
    truncation (`st`) a draw from the truncation distribution of the
    uniform `u` (drawn from `generator` unless given)."""
    if not st:
      return torch.tensor(self.eps, dtype=torch.float32, device=device)
    if u is None:
      u = torch.rand((), generator=generator, device=device)
    eps = self.eps
    if k == 1.0:
      return eps ** (1.0 - u)
    return eps / (1.0 - u * (1.0 - eps ** (k - 1.0))) ** (1.0 / (k - 1.0))

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

  def prior_logp(self, z):
    n = np.prod(z.shape[1:])
    return (-n / 2.0 * np.log(2 * np.pi)
            - (z.reshape(z.shape[0], -1) ** 2).sum(dim=-1) / 2.0)

  def integral_beta(self, t):
    return 0.5 * t ** 2 * (self.beta_1 - self.beta_0) + t * self.beta_0

  def antiderivative(self, t, stabilizing_constant: float = 0.0):
    t = torch.as_tensor(t, dtype=torch.float32)
    ib = self.integral_beta(t)
    return torch.log(1.0 - torch.exp(-ib) + stabilizing_constant) + ib

  def normalizing_constant(self, t_min):
    t_min = torch.as_tensor(t_min, dtype=torch.float32)
    return (self.antiderivative(torch.tensor(self.T, device=t_min.device))
            - self.antiderivative(t_min))

  def get_diffusion_time(self, batch_size: int, t_min, importance_sampling,
                         generator: Optional[torch.Generator] = None,
                         device="cuda", u: Optional[torch.Tensor] = None):
    """(t [B], Z): t from the likelihood-weighting importance distribution
    with its normalising constant Z, or uniform on [t_min, T] with Z = 1.
    `u` [B] replaces the uniform draw."""
    if u is None:
      u = torch.rand(batch_size, generator=generator, device=device)
    if importance_sampling:
      z_norm = self.normalizing_constant(t_min)
      t = (-self.beta_0 + torch.sqrt(
          self.beta_0 ** 2 + 2 * (self.beta_1 - self.beta_0)
          * torch.log(1.0 + torch.exp(z_norm * u
                                      + self.antiderivative(t_min))))
           ) / (self.beta_1 - self.beta_0)
      return t, z_norm.detach()
    return (u * (self.T - t_min) + t_min,
            torch.ones((), dtype=torch.float32, device=u.device))

  def prior_sampling(self, shape, generator: Optional[torch.Generator] = None,
                     device="cuda", noise: Optional[torch.Tensor] = None,
                     data_mean: Optional[torch.Tensor] = None):
    """z ~ N(0, I) of `shape`; `noise` replaces the draw. `data_mean` is
    not read, as in the JAX package."""
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


class VESDE(SDE):
  """Variance-exploding SDE: sigma(t) = sigma_min (sigma_max /
  sigma_min)^t, the SMLD noise levels as its discretisation."""

  def __init__(self, truncation_time=1e-5, sigma_min=0.01, sigma_max=50,
               N=1000):
    super().__init__(N)
    self.sigma_min = float(sigma_min)
    self.sigma_max = float(sigma_max)
    self.eps = float(truncation_time)
    self.discrete_sigmas = torch.exp(torch.from_numpy(linspace_f32(
        np.log(self.sigma_min), np.log(self.sigma_max), N)))

  def _sigma_t(self, t):
    return self.sigma_min * (self.sigma_max / self.sigma_min) ** t

  def sde(self, x, t):
    diffusion = self._sigma_t(t) * math.sqrt(
        2 * (math.log(self.sigma_max) - math.log(self.sigma_min)))
    return torch.zeros_like(x), diffusion

  def marginal_prob(self, x, t):
    return x, self._sigma_t(t)

  def prior_sampling(self, shape, generator: Optional[torch.Generator] = None,
                     device="cuda", noise: Optional[torch.Tensor] = None,
                     data_mean: Optional[torch.Tensor] = None):
    """sigma_max z (+ data_mean), z ~ N(0, I) of `shape`; `noise`
    replaces the draw of z."""
    if noise is None:
      noise = torch.randn(shape, generator=generator, device=device)
    z = noise.to(device=device, dtype=torch.float32) * self.sigma_max
    return z if data_mean is None else z + data_mean

  def prior_logp(self, z):
    n = np.prod(z.shape[1:])
    return (-n / 2.0 * np.log(2 * np.pi * self.sigma_max ** 2)
            - (z.reshape(z.shape[0], -1) ** 2).sum(dim=-1)
            / (2 * self.sigma_max ** 2))

  def antiderivative(self, t):
    """2 log sigma(t), the antiderivative of g(t)^2 / sigma(t)^2."""
    t = torch.as_tensor(t, dtype=torch.float32)
    return 2.0 * torch.log(self._sigma_t(t))

  def normalizing_constant(self, t_min):
    t_min = torch.as_tensor(t_min, dtype=torch.float32)
    return (self.antiderivative(torch.tensor(self.T, device=t_min.device))
            - self.antiderivative(t_min))

  def get_diffusion_time(self, batch_size: int, t_min, importance_sampling,
                         generator: Optional[torch.Generator] = None,
                         device="cuda", u: Optional[torch.Tensor] = None):
    """(t [B], Z): with `importance_sampling` t uniform on [t_min, T] by
    way of the likelihood weighting's importance distribution, t_min + Z u
    / (2 log(sigma_max / sigma_min)), with its normalising constant Z
    (detached); otherwise t uniform on [t_min, T] and Z = 1. `u` [B]
    replaces the uniform draw."""
    if u is None:
      u = torch.rand(batch_size, generator=generator, device=device)
    if importance_sampling:
      z_norm = self.normalizing_constant(t_min)
      t = t_min + (z_norm * u) / (2.0 * (math.log(self.sigma_max)
                                         - math.log(self.sigma_min)))
      return t, z_norm.detach()
    return (u * (self.T - t_min) + t_min,
            torch.ones((), dtype=torch.float32, device=u.device))

  def discretize(self, x, t, next_t=None):
    """SMLD discretization. Without next_t the noise level's index is
    t * (N - 1) truncated, in float32 as the JAX package computes it."""
    if next_t is None:
      timestep = (t * (self.N - 1) / self.T).long()
      sigmas = self.discrete_sigmas.to(x.device)
      sigma = sigmas[timestep]
      adjacent = torch.where(timestep == 0, torch.zeros_like(t),
                             sigmas[torch.clamp(timestep - 1, min=0)])
      G = torch.sqrt(torch.clamp(sigma ** 2 - adjacent ** 2, min=0.0))
    else:
      G = torch.sqrt(torch.clamp(self._sigma_t(t) ** 2
                                 - self._sigma_t(next_t) ** 2, min=0.0))
    return torch.zeros_like(x), G


def get_sde(config) -> SDE:
  name = config.training.sde.lower()
  tt = config.training.truncation_time
  if name == "vpsde":
    return VPSDE(truncation_time=tt, beta_min=config.model.beta_min,
                 beta_max=config.model.beta_max, N=config.model.num_scales)
  if name == "vesde":
    return VESDE(truncation_time=tt, sigma_min=config.model.sigma_min,
                 sigma_max=config.model.sigma_max, N=config.model.num_scales)
  raise NotImplementedError(f"SDE {config.training.sde} is not ported yet.")
