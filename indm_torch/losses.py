"""The score-matching losses, the prior log-likelihood term and the
score-only training step (PyTorch).

Counterpart of `indm_tpu/losses.py:30-254`: the continuous loss, the
discrete SMLD and DDPM losses, `calculate_logp`, the micro-batch
accumulation and the score-only step of `flow.model='identity'`. The
draws (the diffusion time's uniform `u_t`, the perturbation `z`, the soft
truncation's uniform `u_tmin`, the reconstruction term's `z_e`, the
discrete losses' `labels`) come from an explicit `torch.Generator` unless
the caller passes them; the score net's dropout masks come from the same
generator (the reconstruction term's from `recon_generator` when it is
given).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch

from indm_torch import sde as sde_lib
from indm_torch.models.registry import get_model_fn, get_score_fn


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


def get_smld_loss_fn(config, vesde):
  """The discrete SMLD loss (`indm_tpu/losses.py:107-128`): loss_fn(
  model_fn, batch, generator=None, labels=None, z=None) -> [B]. The noise
  level of `labels` (uniform over the N levels, from the largest) scales
  the normal `z`; the net takes the labels themselves."""
  if not isinstance(vesde, sde_lib.VESDE):
    raise ValueError("SMLD training only works for VESDEs.")
  sigma_array = torch.flip(vesde.discrete_sigmas, (0,))
  reduce_op = _reduce_op(config)

  def loss_fn(model_fn, batch, generator=None, labels=None, z=None):
    dev = batch.device
    if labels is None:
      labels = torch.randint(0, vesde.N, (batch.shape[0],),
                             generator=generator, device=dev)
    if z is None:
      z = torch.randn(batch.shape, generator=generator, device=dev)
    sigmas = sigma_array.to(dev)[labels]
    noise = z * sde_lib.right_bcast(sigmas, batch)
    score = model_fn(noise + batch, labels, generator)
    target = -noise / sde_lib.right_bcast(sigmas ** 2, batch)
    return reduce_op(torch.square(score - target)) * sigmas ** 2

  return loss_fn


def get_ddpm_loss_fn(config, vpsde):
  """The discrete DDPM loss (`indm_tpu/losses.py:131-149`): loss_fn(
  model_fn, batch, generator=None, labels=None, z=None) -> [B], the net's
  output against the noise `z` at the DDPM step `labels`."""
  if not isinstance(vpsde, sde_lib.VPSDE):
    raise ValueError("DDPM training only works for VPSDEs.")
  reduce_op = _reduce_op(config)

  def loss_fn(model_fn, batch, generator=None, labels=None, z=None):
    dev = batch.device
    if labels is None:
      labels = torch.randint(0, vpsde.N, (batch.shape[0],),
                             generator=generator, device=dev)
    if z is None:
      z = torch.randn(batch.shape, generator=generator, device=dev)
    perturbed = (sde_lib.right_bcast(
        vpsde.sqrt_alphas_cumprod.to(dev)[labels], batch) * batch
                 + sde_lib.right_bcast(
                     vpsde.sqrt_1m_alphas_cumprod.to(dev)[labels], batch) * z)
    score = model_fn(perturbed, labels, generator)
    return reduce_op(torch.square(score - z))

  return loss_fn


class ScoreNoise(NamedTuple):
  """The draws of one micro-batch's score loss: the continuous loss's
  `u_t` [b], `z`, `u_tmin` (read under `training.st`) and `z_e` (the
  reconstruction term's); the discrete losses' `labels` [b] and `z`."""
  u_t: Optional[torch.Tensor] = None
  z: Optional[torch.Tensor] = None
  u_tmin: Optional[torch.Tensor] = None
  z_e: Optional[torch.Tensor] = None
  labels: Optional[torch.Tensor] = None


def micro_batches(batch: torch.Tensor, num_micro_batch: int):
  """The batch in `num_micro_batch` slices of b // num_micro_batch, the
  remainder dropped (`indm_tpu/losses.py:161-193`); the whole batch for
  one."""
  mb = batch.shape[0] // num_micro_batch
  return [batch[i * mb:(i + 1) * mb] for i in range(num_micro_batch)]


def make_score_step_fn(config, sde, model, optimizer, ema):
  """The score-only step of `flow.model='identity'`
  (`indm_tpu/losses.py:196-254`): step(batch, noise=None, generator=None,
  host_rng=None) -> (the per-example losses [b'] (detached),), b' the
  examples the micro-batches hold: the joint step's call, with "losses"
  alone of `joint.METRICS` and `host_rng` unused. Under `training.continuous` the continuous loss (the
  config's weighting, `training.st`, the reconstruction term) through the
  score function; otherwise SMLD under VESDE or DDPM under a VPSDE (and
  GeometricVP) through the raw net, refused with the likelihood weighting
  and on subVP, as the JAX step refuses them. With `optim.num_micro_batch`
  n each micro-batch's mean loss is backpropagated and the gradients add
  up; then one optimizer update and the EMA. The net runs in the mode the
  caller put it in (train mode: dropout). `noise` is a sequence of n
  `ScoreNoise`, one a micro-batch."""
  if config.training.continuous:
    sde_loss = get_sde_loss_fn(config, sde)
    score_fn = get_score_fn(config, sde, model, continuous=True, train=True)
    discrete = None
  else:
    if config.training.likelihood_weighting:
      raise ValueError("Likelihood weighting is not supported for original "
                       "SMLD/DDPM training.")
    if isinstance(sde, sde_lib.VESDE):
      discrete = get_smld_loss_fn(config, sde)
    elif isinstance(sde, sde_lib.VPSDE):
      discrete = get_ddpm_loss_fn(config, sde)
    else:
      raise ValueError(f"Discrete training for {type(sde).__name__} is not "
                       "recommended (the JAX package refuses it).")
    model_fn = get_model_fn(model, train=True)
  n = config.optim.num_micro_batch

  def step(batch, noise: Optional[Sequence[ScoreNoise]] = None,
           generator: Optional[torch.Generator] = None, host_rng=None):
    optimizer.zero_grad()
    out = []
    for i, mb in enumerate(micro_batches(batch, n)):
      d = ScoreNoise() if noise is None else noise[i]
      if discrete is not None:
        losses = discrete(model_fn, mb, generator, d.labels, d.z)
      else:
        losses = sde_loss(score_fn, mb, st=config.training.st,
                          generator=generator, u_t=d.u_t, z=d.z,
                          u_tmin=d.u_tmin, z_e=d.z_e)
      losses.mean().backward()
      out.append(losses.detach())
    optimizer.step()
    ema.update(optimizer.params)
    return (torch.cat(out),)

  return step
