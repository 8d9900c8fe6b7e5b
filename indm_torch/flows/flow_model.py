"""Flow model construction and `flow_forward` (PyTorch, NCHW).

Counterpart of `indm_tpu/flows/flow_model.py:32-250` for sampling: the
wolf preset with a resflow generator conditioned on h, and the reverse
direction of `flow_forward` (h from the prior flow, then
`ResidualFlow.bwdpass`). The encoding direction needs the wolf encoder and
the log-det estimator, which belong to training and are not ported yet.
"""

from __future__ import annotations

from typing import Optional

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
    self.discriminator = wolf_lib.make_discriminator(wolf_params, generator,
                                                     device)
    n_blocks = tuple(int(b) for b in config.flow.nblocks.split("-"))
    self.generator = _Generator(ResidualFlow(
        image_hw=img, in_ch=ch, n_blocks=n_blocks,
        intermediate_dim=config.flow.intermediate_dim,
        activation_fn=config.flow.act_fn, cond_dim=self.discriminator.dim,
        generator=generator, device=device))

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


def flow_forward(config, flow_model: Optional[FlowModel], x,
                 reverse: bool = False,
                 generator: Optional[torch.Generator] = None,
                 prior_eps: Optional[torch.Tensor] = None):
  """Reverse: latent x [B,C,H,W] -> image, with h sampled from the prior
  flow (`prior_eps` [B, dim] replaces its standard-normal draw). Returns
  (image, None)."""
  if flow_model is None:
    return x, None
  if not reverse:
    raise NotImplementedError("the encoding direction is not ported yet")
  if flow_model.squeeze:
    x = squeeze(x, 2)
  h = flow_model.discriminator.sample_from_prior(x.shape[0], generator,
                                                 prior_eps)
  z, _ = flow_model.resflow.bwdpass(x, h=h)
  if flow_model.squeeze:
    z = unsqueeze(z, 2)
  return z, None
