"""The joint flow + score training steps of INDM (PyTorch).

Counterpart of `indm_tpu/joint.py:46-237`.

`step_nll`, the likelihood variant: z = flow(x), then

    L = L_score(z) + (-(log|det| - KL)) / D + (-log p_T(z_T)) / D

per example (`training.reduce_mean`), one backward to both nets, an AdamW
update of each, the EMA of each, and `update_lipschitz`; the wolf
encoder's BatchNorm running statistics move during the forward.

`step_fid`, the FID variant (`training.likelihood_weighting` off), in two
phases: (1) the same joint loss with importance sampling forced on and
soft truncation off, one backward into both nets, the flow's update, EMA
and `update_lipschitz`; (2) the score loss alone, on the config's own
weighting with no reconstruction term, on z detached: with `training.st`
off z is recomputed under no_grad by the updated flow (no log-det; the
encoder's BatchNorm statistics move a second time) and phase 1's score
gradients are dropped; with it on phase 1's z is reused and the score
gradient is g = const_adj * g_phase1 + h, with const_adj = mean(L_new) /
mean(L_phase1_score) taken without gradient. Then the score net's update
and EMA. Micro-batch accumulation is not ported.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from indm_torch.flows.flow_model import FlowNoise, flow_forward, \
    update_lipschitz
from indm_torch.losses import calculate_logp, get_sde_loss_fn
from indm_torch.models.registry import get_score_fn

METRICS = ("losses", "losses_score", "losses_flow", "losses_logp")


class Phase2Noise(NamedTuple):
  """The draws of `step_fid`'s second phase: the score loss's `u_t` [B]
  and `z` (of the batch's shape), the soft truncation's uniform `u_tmin`
  (a scalar, read under `training.st`), and the encoder's posterior draw
  `enc_eps` [B, dim] of the recompute (read with `training.st` off)."""
  u_t: torch.Tensor
  z: torch.Tensor
  enc_eps: Optional[torch.Tensor] = None
  u_tmin: Optional[torch.Tensor] = None


class StepNoise(NamedTuple):
  """The randomness of one step, for replaying another implementation's:
  the flow's, the loss's diffusion-time uniform `u_t` [B] and perturbation
  `z`, and the prior term's `logp_z` (both of the batch's shape); for
  `step_fid` also its second phase's draws."""
  flow: FlowNoise
  u_t: torch.Tensor
  z: torch.Tensor
  logp_z: torch.Tensor
  phase2: Optional[Phase2Noise] = None


def make_joint_losses(config, sde, score_model, flow_model):
  """joint_losses(batch, noise=None, generator=None, host_rng=None,
  importance_sampling=None, st=None) -> {name: per-example tensor [B]}
  for the names of METRICS and the latent "z", with autograd on. The draws
  come from `generator` (and `host_rng` for the flow's n) unless `noise`
  gives them; `importance_sampling` and `st` override the config's."""
  if config.flow.model == "identity":
    raise ValueError("the joint step needs a flow")
  loss_fn = get_sde_loss_fn(config, sde)
  score_fn = get_score_fn(config, sde, score_model,
                          continuous=config.training.continuous, train=True)
  d_dim = float(config.data.image_size ** 2 * config.data.num_channels)

  def joint_losses(batch, noise: Optional[StepNoise] = None,
                   generator: Optional[torch.Generator] = None,
                   host_rng: Optional[np.random.Generator] = None,
                   importance_sampling: Optional[bool] = None,
                   st: Optional[bool] = None):
    z, logdet_kl = flow_forward(config, flow_model, batch, train=True,
                                noise=None if noise is None else noise.flow,
                                generator=generator, host_rng=host_rng)
    losses_score = loss_fn(score_fn, z,
                           st=config.training.st if st is None else st,
                           generator=generator,
                           u_t=None if noise is None else noise.u_t,
                           z=None if noise is None else noise.z,
                           importance_sampling=importance_sampling)
    losses_logp = calculate_logp(sde, z, generator,
                                 None if noise is None else noise.logp_z)
    if config.training.reduce_mean:
      losses_flow = -logdet_kl / d_dim
      losses_logp = -losses_logp / d_dim
    else:
      losses_flow, losses_logp = -logdet_kl, -losses_logp
    return {"losses": losses_score + losses_flow + losses_logp,
            "losses_score": losses_score, "losses_flow": losses_flow,
            "losses_logp": losses_logp, "z": z}

  return joint_losses


def make_joint_step_fn(config, sde, score_model, flow_model, score_opt,
                       flow_opt, score_ema, flow_ema):
  """The step of the config's variant, `step_nll` under
  `training.likelihood_weighting`, else `step_fid` (`joint.py:237`):
  step(batch, noise=None, generator=None, host_rng=None) -> the
  per-example (losses, losses_score, losses_flow, losses_logp), detached;
  the models, optimizers and EMAs are updated in place. `step_fid` also
  takes `phase_hook`, called with "phase2" where its second phase
  begins."""
  if config.optim.num_micro_batch != 1:
    raise NotImplementedError("micro-batch accumulation is not ported yet")
  joint_losses = make_joint_losses(config, sde, score_model, flow_model)

  def update_flow():
    flow_opt.step()
    flow_ema.update(flow_opt.params)
    update_lipschitz(flow_model)

  def step_nll(batch, noise: Optional[StepNoise] = None,
               generator: Optional[torch.Generator] = None,
               host_rng: Optional[np.random.Generator] = None):
    score_opt.zero_grad()
    flow_opt.zero_grad()
    aux = joint_losses(batch, noise, generator, host_rng)
    aux["losses"].mean().backward()
    score_opt.step()
    score_ema.update(score_opt.params)
    update_flow()
    return tuple(aux[k].detach() for k in METRICS)

  if config.training.likelihood_weighting:
    return step_nll

  loss_fn = get_sde_loss_fn(config, sde)
  score_fn = get_score_fn(config, sde, score_model,
                          continuous=config.training.continuous, train=True)
  st = bool(config.training.st)

  def score_losses(z, p2: Optional[Phase2Noise], generator):
    """Phase 2's score loss on a detached latent: the config's weighting
    and soft truncation, no reconstruction term (`joint.py:156-167`)."""
    return loss_fn(score_fn, z, st=st, generator=generator,
                   u_t=None if p2 is None else p2.u_t,
                   z=None if p2 is None else p2.z, recon_loss=False,
                   u_tmin=None if p2 is None else p2.u_tmin)

  def step_fid(batch, noise: Optional[StepNoise] = None,
               generator: Optional[torch.Generator] = None,
               host_rng: Optional[np.random.Generator] = None,
               phase_hook: Optional[Callable[[str], None]] = None):
    score_opt.zero_grad()
    flow_opt.zero_grad()
    # phase 1: the joint loss, importance sampling on, no soft truncation
    aux = joint_losses(batch, noise, generator, host_rng,
                       importance_sampling=True, st=False)
    aux["losses"].mean().backward()
    update_flow()
    if phase_hook is not None:
      phase_hook("phase2")
    p2 = None if noise is None else noise.phase2
    g1 = [p.grad for p in score_opt.params]
    score_opt.zero_grad()
    if st:
      losses_add = score_losses(aux["z"].detach(), p2, generator)
      losses_add.mean().backward()
      const_adj = (losses_add.detach().mean()
                   / aux["losses_score"].detach().mean())
      with torch.no_grad():
        for p, g in zip(score_opt.params, g1):
          if g is not None:
            p.grad = g * const_adj if p.grad is None else g * const_adj \
                + p.grad
    else:
      del g1
      with torch.no_grad():
        z, _ = flow_forward(config, flow_model, batch, train=True,
                            eval_logdet=False,
                            noise=None if p2 is None
                            else FlowNoise(p2.enc_eps, []),
                            generator=generator)
      losses_add = score_losses(z, p2, generator)
      losses_add.mean().backward()
    score_opt.step()
    score_ema.update(score_opt.params)
    return (aux["losses"].detach(), losses_add.detach(),
            aux["losses_flow"].detach(), aux["losses_logp"].detach())

  return step_fid
