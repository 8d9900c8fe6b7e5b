"""The joint flow + score training step of INDM's likelihood variant
(PyTorch).

Counterpart of `indm_tpu/joint.py:46-152` (`step_nll`): z = flow(x), then

    L = L_score(z) + (-(log|det| - KL)) / D + (-log p_T(z_T)) / D

per example (`training.reduce_mean`), one backward to both nets, an AdamW
update of each, the EMA of each, and `update_lipschitz`; the wolf
encoder's BatchNorm running statistics move during the forward. The FID
variant (`step_fid`) and micro-batch accumulation are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from indm_torch.flows.flow_model import FlowNoise, flow_forward, \
    update_lipschitz
from indm_torch.losses import calculate_logp, get_sde_loss_fn
from indm_torch.models.registry import get_score_fn

METRICS = ("losses", "losses_score", "losses_flow", "losses_logp")


class StepNoise(NamedTuple):
  """The randomness of one step, for replaying another implementation's:
  the flow's, the loss's diffusion-time uniform `u_t` [B] and perturbation
  `z`, and the prior term's `logp_z` (both of the batch's shape)."""
  flow: FlowNoise
  u_t: torch.Tensor
  z: torch.Tensor
  logp_z: torch.Tensor


def make_joint_losses(config, sde, score_model, flow_model):
  """joint_losses(batch, noise=None, generator=None, host_rng=None) ->
  {name: per-example tensor [B]} for the names of METRICS, with autograd
  on. The draws come from `generator` (and `host_rng` for the flow's n)
  unless `noise` gives them."""
  if config.flow.model == "identity":
    raise ValueError("the joint step needs a flow")
  loss_fn = get_sde_loss_fn(config, sde)
  score_fn = get_score_fn(config, sde, score_model,
                          continuous=config.training.continuous, train=True)
  d_dim = float(config.data.image_size ** 2 * config.data.num_channels)

  def joint_losses(batch, noise: Optional[StepNoise] = None,
                   generator: Optional[torch.Generator] = None,
                   host_rng: Optional[np.random.Generator] = None):
    z, logdet_kl = flow_forward(config, flow_model, batch, train=True,
                                noise=None if noise is None else noise.flow,
                                generator=generator, host_rng=host_rng)
    losses_score = loss_fn(score_fn, z, st=config.training.st,
                           generator=generator,
                           u_t=None if noise is None else noise.u_t,
                           z=None if noise is None else noise.z)
    losses_logp = calculate_logp(sde, z, generator,
                                 None if noise is None else noise.logp_z)
    if config.training.reduce_mean:
      losses_flow = -logdet_kl / d_dim
      losses_logp = -losses_logp / d_dim
    else:
      losses_flow, losses_logp = -logdet_kl, -losses_logp
    return {"losses": losses_score + losses_flow + losses_logp,
            "losses_score": losses_score, "losses_flow": losses_flow,
            "losses_logp": losses_logp}

  return joint_losses


def make_joint_step_fn(config, sde, score_model, flow_model, score_opt,
                       flow_opt, score_ema, flow_ema):
  """step_nll(batch, noise=None, generator=None, host_rng=None) -> the
  per-example (losses, losses_score, losses_flow, losses_logp), detached;
  the models, optimizers and EMAs are updated in place."""
  if not config.training.likelihood_weighting:
    raise NotImplementedError("the FID variant (step_fid) is not ported yet")
  if config.optim.num_micro_batch != 1:
    raise NotImplementedError("micro-batch accumulation is not ported yet")
  joint_losses = make_joint_losses(config, sde, score_model, flow_model)

  def step_nll(batch, noise: Optional[StepNoise] = None,
               generator: Optional[torch.Generator] = None,
               host_rng: Optional[np.random.Generator] = None):
    score_opt.zero_grad()
    flow_opt.zero_grad()
    aux = joint_losses(batch, noise, generator, host_rng)
    aux["losses"].mean().backward()
    score_opt.step()
    flow_opt.step()
    score_ema.update(score_opt.params)
    flow_ema.update(flow_opt.params)
    update_lipschitz(flow_model)
    return tuple(aux[k].detach() for k in METRICS)

  return step_nll
