"""Likelihood in bits/dim (PyTorch): the probability-flow ODE's NLL, the
NELBO and the truncation residual.

Counterpart of `indm_tpu/likelihood.py`. The functions take closures:

  score_fn(x, t) -> score, in eval mode and differentiable in x
    (`registry.get_score_fn(..., differentiable=True)`);
  flow_forward_fn(x) -> (z, log_jacob [B]) or None (no flow).

Each ODE function evaluation computes the drift and its Hutchinson
divergence from one forward of the score net and one VJP through it. Every
draw can be passed in (the `*Noise` tuples), so that a test can replay the
JAX package's; otherwise it comes from `generator` on the data's device.
The ODE is solved by the port's RK45 (`indm_torch.ode.solve_rk45`) on the
flattened state followed by the B log-p entries, as the JAX solve holds it,
so that the error norm is the same.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from indm_torch import ode as ode_lib
from indm_torch.sde import right_bcast


def rademacher_like(x, generator: Optional[torch.Generator] = None):
  return torch.randint(0, 2, x.shape, generator=generator, device=x.device
                       ).to(x.dtype) * 2 - 1.0


def hutchinson_eps(x, hutchinson_type: str,
                   generator: Optional[torch.Generator] = None):
  if hutchinson_type == "Gaussian":
    return torch.randn(x.shape, generator=generator, device=x.device)
  if hutchinson_type == "Rademacher":
    return rademacher_like(x, generator)
  raise NotImplementedError(f"Hutchinson type {hutchinson_type} unknown.")


def div_from(out, x, eps):
  """The Hutchinson-Skilling divergence sum(eps * J^T eps) [B] of out(x):
  one VJP through the graph from x (which requires grad) to out."""
  (vjp,) = torch.autograd.grad(out, x, eps)
  return (vjp * eps).flatten(1).sum(1)


def get_div_fn(fn):
  """div_fn(x, t, eps): the Hutchinson-Skilling divergence of fn(x, t)
  through one VJP (`likelihood.py:36`)."""

  def div_fn(x, t, eps):
    with torch.enable_grad():
      x = x.detach().requires_grad_(True)
      return div_from(fn(x, t), x, eps)

  return div_fn


class ResidualNoise(NamedTuple):
  """The residual's two standard normals, each of the batch's shape."""
  z1: torch.Tensor
  z2: torch.Tensor


def get_likelihood_residual_fn(config, sde, score_fn,
                               variance: str = "scoreflow",
                               eps_bpd: float = 1e-5):
  """residual_fn(batch, generator=None, noise=None) -> residual [B], the
  truncation gap's correction (`likelihood.py:49`). The score is read
  once, under no_grad."""

  def residual_fn(batch, generator: Optional[torch.Generator] = None,
                  noise: Optional[ResidualNoise] = None):
    if noise is None:
      noise = ResidualNoise(
          *(torch.randn(batch.shape, generator=generator,
                        device=batch.device) for _ in range(2)))
    b = batch.shape[0]
    tt = config.training.truncation_time
    eps_vec = torch.full((b,), tt, device=batch.device)
    mean, std = sde.marginal_prob(batch, eps_vec)
    perturbed = mean + right_bcast(std, batch) * noise.z1
    with torch.no_grad():
      score = score_fn(perturbed, eps_vec)
    est_noise = -right_bcast(std, batch) * score

    eps_vec2 = torch.full((b,), eps_bpd, device=batch.device)
    mean2, std2 = sde.marginal_prob(batch, eps_vec2)
    perturbed2 = mean2 + right_bcast(std2, batch) * noise.z2

    alpha, beta = sde.marginal_prob(torch.ones_like(batch), eps_vec2)
    q_mean = (perturbed2 / alpha
              - right_bcast(beta, batch) * est_noise / alpha)
    if variance == "ddpm":
      q_std = beta
    elif variance == "scoreflow":
      q_std = beta / alpha.mean(dim=(1, 2, 3))
    else:
      raise ValueError(variance)

    n_dim = np.prod(batch.shape[1:])
    p_entropy = n_dim / 2.0 * (np.log(2 * np.pi) + 2 * torch.log(std2) + 1.0)
    q_recon = (n_dim / 2.0 * (np.log(2 * np.pi) + 2 * torch.log(q_std))
               + 0.5 / q_std ** 2
               * torch.square(batch - q_mean).sum(dim=(1, 2, 3)))
    return q_recon - p_entropy

  return residual_fn


class LikelihoodNoise(NamedTuple):
  """The draws of one `likelihood_fn` call: the Hutchinson `epsilon`, the
  perturbation `z0` and the residual's (each of the data's shape)."""
  epsilon: torch.Tensor
  z0: torch.Tensor
  residual: ResidualNoise


def get_likelihood_fn(config, sde, inverse_scaler,
                      hutchinson_type: str = "Rademacher",
                      rtol: float = 1e-5, atol: float = 1e-5):
  """likelihood_fn(score_fn, flow_forward_fn, data, logdet=None,
  residual=True, eps_bpd=1e-5, generator=None, noise=None) ->
  (bpd [B], z, nfe): the ODE log-likelihood in bits/dim
  (`likelihood.py:91`)."""

  def drift_fn(score_fn, x, t):
    return sde.reverse(score_fn, probability_flow=True).sde(x, t)[0]

  def likelihood_fn(score_fn, flow_forward_fn, data, logdet=None,
                    residual: bool = True, eps_bpd: float = 1e-5,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[LikelihoodNoise] = None):
    shape = data.shape
    b = shape[0]
    d = int(np.prod(shape[1:]))
    if noise is None:
      noise = LikelihoodNoise(
          hutchinson_eps(data, hutchinson_type, generator),
          torch.randn(shape, generator=generator, device=data.device),
          ResidualNoise(*(torch.randn(shape, generator=generator,
                                      device=data.device)
                          for _ in range(2))))
    epsilon = noise.epsilon

    if flow_forward_fn is not None:
      data, log_jacob = flow_forward_fn(data)
    else:
      log_jacob = torch.zeros(b, device=data.device)

    if residual:
      mean, std = sde.marginal_prob(
          data, torch.full((b,), eps_bpd, device=data.device))
      init_x = mean + right_bcast(std, data) * noise.z0
    else:
      init_x = data
    init = torch.cat([init_x.reshape(-1),
                      torch.zeros(b, device=data.device)])

    def ode_fn(t, y):
      x = y[:-b].reshape(shape).detach().requires_grad_(True)
      vec_t = torch.full((b,), float(t), device=y.device)
      with torch.enable_grad():
        drift = drift_fn(score_fn, x, vec_t)
        div = div_from(drift, x, epsilon)
      return torch.cat([drift.detach().reshape(-1), div])

    y, nfe = ode_lib.solve_rk45(ode_fn, eps_bpd, sde.T, init, rtol=rtol,
                                atol=atol)
    z = y[:-b].reshape(shape)
    delta_logp = y[-b:]
    prior_logp = sde.prior_logp(z)

    if residual:
      residual_fn = get_likelihood_residual_fn(config, sde, score_fn,
                                               eps_bpd=eps_bpd)
      delta_logp = delta_logp - residual_fn(data, noise=noise.residual)
    if logdet is None:
      logdet = torch.zeros(b, device=data.device)

    bpd = -(prior_logp + delta_logp + logdet + log_jacob) / np.log(2) / d
    offset = 7.0 - inverse_scaler(-1.0)
    return bpd + offset, z, nfe

  return likelihood_fn


class ElboNoise(NamedTuple):
  """The draws of one `elbo_fn` call: the diffusion time's uniform `u_t`
  [B], the perturbation `z`, the Hutchinson `epsilon`, the prior term's
  `lp_z` (each of the batch's shape) and the residual's."""
  u_t: torch.Tensor
  z: torch.Tensor
  epsilon: torch.Tensor
  lp_z: torch.Tensor
  residual: ResidualNoise


def get_elbo_fn(config, sde, inverse_scaler=None,
                hutchinson_type: str = "Rademacher"):
  """elbo_fn(score_fn, flow_forward_fn, batch, logdet=None,
  generator=None, noise=None) -> (nelbo_bpd [B], nelbo_residual_bpd [B]):
  the single-sample interior NELBO (`likelihood.py:155`). The score at
  the perturbed batch is read once, from the forward whose VJP gives the
  divergence term (the JAX function evaluates it twice)."""

  def elbo_fn(score_fn, flow_forward_fn, batch, logdet=None,
              generator: Optional[torch.Generator] = None,
              noise: Optional[ElboNoise] = None):
    b = batch.shape[0]
    dev = batch.device
    if flow_forward_fn is not None:
      batch, log_jacob = flow_forward_fn(batch)
    else:
      log_jacob = torch.zeros(b, device=dev)
    if logdet is None:
      logdet = torch.zeros(b, device=dev)
    if noise is None:
      noise = ElboNoise(
          torch.rand(b, generator=generator, device=dev),
          torch.randn(batch.shape, generator=generator, device=dev),
          hutchinson_eps(batch, hutchinson_type, generator),
          torch.randn(batch.shape, generator=generator, device=dev),
          ResidualNoise(*(torch.randn(batch.shape, generator=generator,
                                      device=dev) for _ in range(2))))

    # the GVP quirk: interior t from [1e-6, T] (`likelihood.py:184-188`)
    t_min = 1e-6 if config.training.sde == "gvpsde" else sde.eps
    t, Z = sde.get_diffusion_time(
        b, torch.tensor(t_min, dtype=torch.float32, device=dev), True,
        device=dev, u=noise.u_t)
    qt = 1.0 / sde.T
    mean, std = sde.marginal_prob(batch, t)
    std_b = right_bcast(std, batch)
    perturbed = mean + std_b * noise.z

    x = perturbed.detach().requires_grad_(True)
    with torch.enable_grad():
      score = score_fn(x, t)
      f, g = sde.sde(x, t)
      s2 = std_b ** 2
      mu = s2 * score - s2 / right_bcast(g, batch) ** 2 * f
      Mu = -div_from(mu, x, noise.epsilon) * Z / qt
    a = std_b * score.detach()
    Nu = -(a ** 2).flatten(1).sum(1) * Z / 2.0 / qt

    lp_t = torch.full((b,), sde.T, device=dev)
    lp_mean, lp_std = sde.marginal_prob(batch, lp_t)
    lp = sde.prior_logp(lp_mean + right_bcast(lp_std, batch) * noise.lp_z)

    elbos = lp + Mu + Nu + log_jacob
    residual_fn = get_likelihood_residual_fn(
        config, sde, score_fn, eps_bpd=config.training.truncation_time)
    elbos_residual = elbos - residual_fn(batch, noise=noise.residual)

    d = np.prod(batch.shape[1:])
    offset = 7.0 - inverse_scaler(-1.0)
    nelbo = -(elbos + logdet) / d / np.log(2) + offset
    nelbo_res = -(elbos_residual + logdet) / d / np.log(2) + offset
    return nelbo.detach(), nelbo_res.detach()

  return elbo_fn
