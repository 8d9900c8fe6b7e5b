"""The VP, subVP, VE and GeometricVP SDEs and their reverse-time SDE/ODE
(PyTorch).

Counterpart of `indm_tpu/sde.py:27-410`. Tensors keep a
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
    """The Euler-Maruyama step of 1 / N (next_t is not read): f = drift
    dt, G = diffusion sqrt(dt)."""
    dt = 1.0 / self.N
    drift, diffusion = self.sde(x, t)
    return drift * dt, diffusion * math.sqrt(dt)

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
    self._set_tables(betas)

  def _set_tables(self, betas: np.ndarray):
    """The DDPM tables of float64 `betas`, cast to float32 at the end."""
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)
    self.discrete_betas = f32(betas)
    self.alphas = f32(alphas)
    self.alphas_cumprod = f32(alphas_cumprod)
    self.sqrt_alphas_cumprod = f32(np.sqrt(alphas_cumprod))
    self.sqrt_1m_alphas_cumprod = f32(np.sqrt(1.0 - alphas_cumprod))

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
    """z (+ data_mean), z ~ N(0, I) of `shape`; `noise` replaces the
    draw."""
    if noise is None:
      noise = torch.randn(shape, generator=generator, device=device)
    z = noise.to(device=device, dtype=torch.float32)
    return z if data_mean is None else z + data_mean

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


class subVPSDE(SDE):
  """The sub-VP SDE. Its `marginal_prob` returns as std the variance-like
  1 - exp(2 log_mean_coeff), with no square root, as the JAX package and
  the reference do. It has no discrete tables, no antiderivative and no
  importance distribution."""

  def __init__(self, truncation_time=1e-5, beta_min=0.1, beta_max=20,
               N=1000):
    super().__init__(N)
    self.beta_0 = float(beta_min)
    self.beta_1 = float(beta_max)
    self.eps = float(truncation_time)

  def sde(self, x, t):
    beta_t = self.beta_0 + t * (self.beta_1 - self.beta_0)
    drift = -0.5 * right_bcast(beta_t, x) * x
    discount = 1.0 - torch.exp(-2 * self.beta_0 * t
                               - (self.beta_1 - self.beta_0) * t ** 2)
    return drift, torch.sqrt(beta_t * discount)

  def marginal_prob(self, x, t):
    log_mean_coeff = (-0.25 * t ** 2 * (self.beta_1 - self.beta_0)
                      - 0.5 * t * self.beta_0)
    mean = torch.exp(right_bcast(log_mean_coeff, x)) * x
    return mean, 1.0 - torch.exp(2.0 * log_mean_coeff)

  def prior_sampling(self, shape, generator: Optional[torch.Generator] = None,
                     device="cuda", noise: Optional[torch.Tensor] = None,
                     data_mean: Optional[torch.Tensor] = None):
    """z ~ N(0, I) of `shape`; `noise` replaces the draw; `data_mean` is
    not read, as in the JAX package."""
    if noise is None:
      noise = torch.randn(shape, generator=generator, device=device)
    return noise.to(device=device, dtype=torch.float32)

  def prior_logp(self, z):
    return VPSDE.prior_logp(self, z)

  def get_diffusion_time(self, batch_size: int, t_min, importance_sampling,
                         generator: Optional[torch.Generator] = None,
                         device="cuda", u: Optional[torch.Tensor] = None):
    """(t uniform on [t_min, T], 1) whatever `importance_sampling` says."""
    if u is None:
      u = torch.rand(batch_size, generator=generator, device=device)
    return (u * (self.T - t_min) + t_min,
            torch.ones((), dtype=torch.float32, device=u.device))


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


class GeometricVPSDE(VPSDE):
  """The geometric VP SDE, a VPSDE by subclass (the samplers' VP branches
  take it): sigma^2(t) = sigma2_min (sigma2_max / sigma2_min)^t, its DDPM
  tables with betas clipped to [0, 0.999] (the reference's geometric tail
  passes 1 and turns sqrt(alphas_cumprod) NaN), a discretization that
  needs `next_t`, its own `integral_beta` (so its own antiderivative) and
  a uniform diffusion time."""

  def __init__(self, truncation_time=1e-5, beta_min=0.1, beta_max=20,
               N=1000, sigma2_min=3e-5, sigma2_max=0.999):
    SDE.__init__(self, N)
    self.sigma2_0 = float(sigma2_min)
    self.sigma2_min = float(sigma2_min)
    self.sigma2_max = float(sigma2_max)
    log_term = math.log(self.sigma2_max / self.sigma2_min)
    self.beta_0 = (self.sigma2_min / (1.0 - self.sigma2_min)) * log_term
    self.beta_1 = (self.sigma2_max / (1.0 - self.sigma2_max)) * log_term
    self.eps = float(truncation_time)
    t = np.linspace(0, 1, N)
    sigma2_geom = self.sigma2_min * ((self.sigma2_max / self.sigma2_min) ** t)
    betas = sigma2_geom * log_term / (
        1.0 - self.sigma2_0 + self.sigma2_min - sigma2_geom)
    self._set_tables(np.clip(betas, 0.0, 0.999))

  def _r_pow(self, t):
    """(sigma2_max / sigma2_min)^t in float32, correctly rounded (a float64
    pow, then the cast), as XLA's float32 pow nearly is: torch's float32
    pow differs from it in the last bit in about 2 % of arguments, which
    beta(t)'s denominator, 1e-3 at t = 1, multiplies by 1000."""
    return ((self.sigma2_max / self.sigma2_min) ** t.double()).to(t.dtype)

  def _geom_beta_t(self, t):
    r = self.sigma2_max / self.sigma2_min
    sigma2_geom = self.sigma2_min * self._r_pow(t)
    return sigma2_geom * math.log(r) / (
        1.0 - self.sigma2_0 + self.sigma2_min - sigma2_geom)

  def sde(self, x, t):
    beta_t = self._geom_beta_t(t)
    return -0.5 * right_bcast(beta_t, x) * x, torch.sqrt(beta_t)

  def marginal_prob(self, x, t):
    r_t = self._r_pow(t)
    mean = torch.sqrt(1.0 + self.sigma2_min * (1.0 - right_bcast(r_t, x))
                      / (1.0 - self.sigma2_0)) * x
    std = torch.sqrt(self.sigma2_min * r_t - self.sigma2_min
                     + self.sigma2_0)
    return mean, std

  def discretize(self, x, t, next_t=None):
    if next_t is None:
      raise NotImplementedError(
          "GeometricVPSDE.discretize needs next_t, as in the JAX package: "
          "the reverse-diffusion predictor without next_t (the plain PC "
          "loop) does not run on gvpsde")
    G = torch.sqrt(torch.clamp((t - next_t) * self._geom_beta_t(t),
                               min=0.0))
    return right_bcast(torch.sqrt(1.0 - G ** 2), x) * x - x, G

  def integral_beta(self, t):
    # a float32 division: torch's scalar / tensor multiplies by the
    # reciprocal, a second rounding that log near 1 magnifies
    num = torch.full_like(t, 1.0 - self.sigma2_min)
    return torch.log(num / (1.0 - self.sigma2_min * self._r_pow(t)))

  def get_diffusion_time(self, batch_size: int, t_min, importance_sampling,
                         generator: Optional[torch.Generator] = None,
                         device="cuda", u: Optional[torch.Tensor] = None):
    """(t uniform on [t_min, T], 1): the reference has no importance
    distribution for it."""
    return subVPSDE.get_diffusion_time(self, batch_size, t_min, False,
                                       generator, device, u)


def get_sde(config) -> SDE:
  name = config.training.sde.lower()
  tt = config.training.truncation_time
  if name == "vpsde":
    return VPSDE(truncation_time=tt, beta_min=config.model.beta_min,
                 beta_max=config.model.beta_max, N=config.model.num_scales)
  if name == "subvpsde":
    return subVPSDE(truncation_time=tt, beta_min=config.model.beta_min,
                    beta_max=config.model.beta_max, N=config.model.num_scales)
  if name == "vesde":
    return VESDE(truncation_time=tt, sigma_min=config.model.sigma_min,
                 sigma_max=config.model.sigma_max, N=config.model.num_scales)
  if name == "gvpsde":
    return GeometricVPSDE(truncation_time=tt, beta_min=config.model.beta_min,
                          beta_max=config.model.beta_max,
                          N=config.model.num_scales)
  raise NotImplementedError(f"SDE {config.training.sde} unknown.")
