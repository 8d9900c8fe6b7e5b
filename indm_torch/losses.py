"""The continuous score-matching loss and the prior log-likelihood term
(PyTorch).

Counterpart of `indm_tpu/losses.py:30-105, 152-158`. The draws (the
diffusion time's uniform `u_t`, the perturbation `z`) come from an
explicit `torch.Generator` unless the caller passes them; the score net's
dropout masks come from the same generator. The one-step reconstruction
term (`training.reconstruction_loss`) belongs to the FID step and is not
ported yet.
"""

from __future__ import annotations

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
  score function carries the train flag)."""
  if config.training.reconstruction_loss:
    raise NotImplementedError("the reconstruction term is not ported yet")
  reduce_op = _reduce_op(config)
  importance_sampling = config.training.importance_sampling

  def loss_fn(score_fn, batch, st: bool = False,
              generator: Optional[torch.Generator] = None,
              u_t: Optional[torch.Tensor] = None,
              z: Optional[torch.Tensor] = None):
    dev = batch.device
    t_min = sde.get_t_min(st, config.training.k, generator, dev)
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
