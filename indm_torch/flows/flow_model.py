"""Flow model construction and `flow_forward` (PyTorch, NCHW).

Counterpart of `indm_tpu/flows/flow_model.py:32-295`: the wolf preset with a
resflow generator conditioned on h; the reverse direction of
`flow_forward` (h from the prior flow, then `ResidualFlow.bwdpass`) and the
encoding direction (h from the Gaussian encoder, then
`ResidualFlow.fwdpass`) with the training log-det estimator or, in eval
mode, the evaluation estimator; `update_lipschitz`.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from indm_torch.configs.wolf_presets import load_wolf_params
from indm_torch.flows import wolf as wolf_lib
from indm_torch.flows.resflow import ResidualFlow, squeeze, unsqueeze


class _Generator(nn.Module):

  def __init__(self, flow):
    super().__init__()
    self.flow = flow


class FlowModel(nn.Module):
  """`generator.flow` is the residual flow and `discriminator` the
  Gaussian discriminator with its prior, as in the reference WolfCore."""

  def __init__(self, config, generator=None, device=None):
    super().__init__()
    if config.flow.model != "wolf":
      raise NotImplementedError(f"flow.model={config.flow.model!r} is not "
                                "ported yet")
    if config.flow.actnorm:
      raise NotImplementedError("flow.actnorm is not ported yet")
    self.squeeze = bool(config.flow.squeeze)
    img = config.data.image_size
    ch = config.data.num_channels
    if self.squeeze:
      img, ch = img // 2, ch * 4
    wolf_params = load_wolf_params(config.flow.model_config)
    gen_kind = wolf_params["generator"]["flow"].get("type", "resflow")
    if gen_kind != "resflow":
      raise NotImplementedError(f"wolf generator {gen_kind!r} is not ported")
    self.discriminator = wolf_lib.make_discriminator(wolf_params, img, ch,
                                                     generator, device)
    n_blocks = tuple(int(b) for b in config.flow.nblocks.split("-"))
    self.generator = _Generator(ResidualFlow(
        image_hw=img, in_ch=ch, n_blocks=n_blocks,
        intermediate_dim=config.flow.intermediate_dim,
        activation_fn=config.flow.act_fn, cond_dim=self.discriminator.dim,
        generator=generator, device=device,
        fused_block=bool(config.flow.get("fused_block", False)),
        compute_dtype=flow_compute_dtype(config),
        mixed_precision=bool(config.flow.get("mixed_precision", False)),
        unroll_terms=int(config.flow.get("logdet_unroll", 0) or 0)))

  @property
  def resflow(self) -> ResidualFlow:
    return self.generator.flow


def create_flow_model(config, seed: int = 1,
                      device="cuda") -> Optional[FlowModel]:
  """The flow with weights drawn from `seed` on the CPU, moved to `device`;
  None for `flow.model='identity'`."""
  if config.flow.model == "identity":
    return None
  gen = torch.Generator().manual_seed(seed)
  return FlowModel(config, generator=gen).to(device).eval()


class FlowNoise(NamedTuple):
  """The randomness of one training forward: the encoder's posterior draw
  eps [B, dim] and each iResBlock's (vareps, n), in run order."""
  enc_eps: torch.Tensor
  blocks: List[Tuple[torch.Tensor, int]]


def sample_flow_noise(flow_model: FlowModel, x_shape,
                      generator: Optional[torch.Generator] = None,
                      host_rng: Optional[np.random.Generator] = None,
                      device=None) -> FlowNoise:
  """Fresh noise for `flow_forward(train=True)` on an input of `x_shape`:
  the normal draws from `generator` on `device`, each block's n from the
  host's `host_rng`."""
  b, c, h, w = x_shape
  if flow_model.squeeze:
    c, h, w = c * 4, h // 2, w // 2
  enc_eps = torch.randn((b, flow_model.discriminator.dim),
                        generator=generator, device=device)
  return FlowNoise(enc_eps, flow_model.resflow.sample_noise(
      (b, c, h, w), generator, host_rng, device))


def flow_forward(config, flow_model: Optional[FlowModel], x,
                 reverse: bool = False,
                 generator: Optional[torch.Generator] = None,
                 prior_eps: Optional[torch.Tensor] = None,
                 train: bool = False, noise: Optional[FlowNoise] = None,
                 host_rng: Optional[np.random.Generator] = None,
                 eval_logdet: bool = True):
  """Reverse: latent x [B,C,H,W] -> image, with h sampled from the prior
  flow (`prior_eps` [B, dim] replaces its standard-normal draw). Returns
  (image, None).

  Forward: image x -> (z, log|det| - KL [B]), the wolf branch's
  `logdet_kl`. `noise` replaces the draws of `sample_flow_noise`. With
  `train` the training estimator, and the encoder's BatchNorm running
  statistics move in place. Without it (`indm_tpu/flows/flow_model.py:
  180-250`, train=False) the evaluation estimator, the BatchNorm on its
  running statistics whatever the module's mode, nothing differentiable
  out; with no `noise` the draws come from a torch generator and a numpy
  generator both seeded 0 afresh in each call, so that every call draws
  the same, as the JAX package's `PRNGKey(0)` does (`generator` and
  `host_rng` are not read).

  Without `eval_logdet` (`flow_model.py:180-186`) no log-det is
  estimated: each iResBlock is x + g(x), the only draw is the encoder's
  posterior eps (`noise.enc_eps`; its blocks are not read), and the
  result is (z, None). With `train` the encoder's BatchNorm still takes
  the batch's statistics and moves its running ones, under no_grad too,
  as the FID step's second phase needs (`indm_tpu/joint.py:206-208`)."""
  if flow_model is None:
    return x, (None if reverse else torch.zeros(x.shape[0], device=x.device))
  if not reverse:
    if noise is None:
      if not train:
        generator = torch.Generator(device=x.device).manual_seed(0)
        host_rng = np.random.default_rng(0)
      noise = (sample_flow_noise(flow_model, x.shape, generator, host_rng,
                                 x.device) if eval_logdet else
               FlowNoise(torch.randn((x.shape[0],
                                      flow_model.discriminator.dim),
                                     generator=generator, device=x.device),
                         []))
    if flow_model.squeeze:
      x = squeeze(x, 2)
    disc = flow_model.discriminator
    mode = disc.training
    disc.train(mode and train)
    try:
      with torch.set_grad_enabled(train and torch.is_grad_enabled()):
        h, kl = disc.sampling_and_kl(x, noise.enc_eps)
        if eval_logdet:
          z, logpx = flow_model.resflow.fwdpass(x, h, noise.blocks, train)
        else:
          z, logpx = flow_model.resflow.fwdpass_plain(x, h), None
    finally:
      disc.train(mode)
    if flow_model.squeeze:
      z = unsqueeze(z, 2)
    return z, (-logpx - kl if eval_logdet else None)
  if flow_model.squeeze:
    x = squeeze(x, 2)
  h = flow_model.discriminator.sample_from_prior(x.shape[0], generator,
                                                 prior_eps)
  z, _ = flow_model.resflow.bwdpass(x, h=h)
  if flow_model.squeeze:
    z = unsqueeze(z, 2)
  return z, None


def flow_compute_dtype(config):
  """The flow kernels' compute type: bfloat16 under `flow.logdet_bf16` or
  `flow.mixed_precision`, as the JAX package picks it on every route
  (`resflow.py:571-572, 653-654, 930-931`), else float32. The training
  estimator takes the kernel route whatever `flow.logdet_pallas` says: the
  chain (kernel 7, or kernel 8 under INDM_FUSED_CHAIN=1) or, with
  `flow.fused_block`, the fused pair and stacks."""
  f = config.flow
  return (torch.bfloat16 if f.get("logdet_bf16", False)
          or f.get("mixed_precision", False) else torch.float32)


def update_lipschitz(flow_model: Optional[FlowModel]):
  """The post-step Lipschitz projection (`indm_tpu/flows/flow_model.py:
  282-295`). Every Lipschitz layer of INDM's flow (vnorms 'ffff') is a
  `LopConv2d`, which bounds its weight inside its forward: there is no
  power-iteration state, and the projection is the identity."""
  return flow_model
