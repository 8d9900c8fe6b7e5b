"""The continuous score-matching loss and the prior log-likelihood term
(PyTorch).

Counterpart of `indm_tpu/losses.py:30-105, 152-158`. The draws (the
diffusion time's uniform `u_t`, the perturbation `z`, the soft
truncation's uniform `u_tmin`, and the reconstruction term's `z_e`) come
from an explicit `torch.Generator` unless the caller passes them; the
score net's dropout masks come from the same generator (the
reconstruction term's from `recon_generator` when it is given).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from indm_torch import sde as sde_lib


def _reduce_op(config):
  if config.training.reduce_mean:
    return lambda x: x.reshape(x.shape[0], -1).mean(dim=-1)
  return lambda x: x.reshape(x.shape[0], -1).sum(dim=-1)


def get_sde_loss_fn(config, sde):
  """loss_fn(score_fn, batch, ...) -> per-example losses [B], with the
  importance-sampling, likelihood or plain weighting of the config (the
  score function carries the train flag). `importance_sampling` and
  `recon_loss` override the config's `training.importance_sampling` and
  `training.reconstruction_loss` for one call, as the JAX package's
  `loss_fn` takes them; the reconstruction term is the one-step denoising
  reconstruction at t_min with the "scoreflow" variance of `q`."""
  reduce_op = _reduce_op(config)

  def loss_fn(score_fn, batch, st: bool = False,
              generator: Optional[torch.Generator] = None,
              u_t: Optional[torch.Tensor] = None,
              z: Optional[torch.Tensor] = None,
              recon_loss: Optional[bool] = None,
              importance_sampling: Optional[bool] = None,
              u_tmin: Optional[torch.Tensor] = None,
              z_e: Optional[torch.Tensor] = None,
              recon_generator: Optional[torch.Generator] = None):
    if recon_loss is None:
      recon_loss = config.training.reconstruction_loss
    if importance_sampling is None:
      importance_sampling = config.training.importance_sampling
    dev = batch.device
    t_min = sde.get_t_min(st, config.training.k, generator, dev, u=u_tmin)
    t, weight = sde.get_diffusion_time(batch.shape[0], t_min,
                                       importance_sampling, generator, dev,
                                       u=u_t)
    if z is None:
      z = torch.randn(batch.shape, generator=generator, device=dev)
    mean, std = sde.marginal_prob(batch, t)
    std_b = sde_lib.right_bcast(std, batch)
    score = score_fn(mean + std_b * z, t, generator)

    if importance_sampling:
      losses = 0.5 * weight * reduce_op(torch.square(score * std_b + z))
    elif config.training.likelihood_weighting:
      g2 = sde.sde(torch.zeros_like(batch), t)[1] ** 2
      losses = 0.5 * weight * reduce_op(torch.square(score + z / std_b)) * g2
    else:
      losses = 0.5 * weight * reduce_op(torch.square(score * std_b + z))

    if recon_loss:
      # one-step denoising reconstruction at t_min (`losses.py:75-93`)
      eps_vec = torch.full((batch.shape[0],), 1.0, device=dev) * t_min
      mean_e, std_e = sde.marginal_prob(batch, eps_vec)
      if z_e is None:
        z_e = torch.randn(batch.shape, generator=generator, device=dev)
      perturbed_e = mean_e + sde_lib.right_bcast(std_e, batch) * z_e
      score_e = score_fn(perturbed_e, eps_vec,
                         generator if recon_generator is None
                         else recon_generator)
      alpha, beta = sde.marginal_prob(torch.ones_like(batch), eps_vec)
      q_mean = (perturbed_e / alpha
                + sde_lib.right_bcast(beta, batch) ** 2 * score_e / alpha)
      q_std = beta / alpha.mean(dim=(1, 2, 3))
      n_dim = math.prod(batch.shape[1:])
      log2pi = math.log(2 * math.pi)
      p_entropy = n_dim / 2.0 * (log2pi + 2 * torch.log(std_e) + 1.0)
      q_recon = (n_dim / 2.0 * (log2pi + 2 * torch.log(q_std))
                 + 0.5 / q_std ** 2
                 * torch.square(batch - q_mean).sum(dim=(1, 2, 3)))
      recon = q_recon - p_entropy
      if config.training.reduce_mean:
        recon = recon / n_dim
      losses = losses + recon
    return losses

  return loss_fn


def calculate_logp(sde, batch, generator: Optional[torch.Generator] = None,
                   z: Optional[torch.Tensor] = None):
  """log p_T of the latent diffused to T, per example [B]; `z` replaces
  the draw."""
  ts = torch.full((batch.shape[0],), sde.T, device=batch.device)
  mean_t, std_t = sde.marginal_prob(batch, ts)
  if z is None:
    z = torch.randn(batch.shape, generator=generator, device=batch.device)
  return sde.prior_logp(mean_t + sde_lib.right_bcast(std_t, batch) * z)
