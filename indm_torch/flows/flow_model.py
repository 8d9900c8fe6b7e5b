"""Flow model construction and `flow_forward` (PyTorch, NCHW).

Counterpart of `indm_tpu/flows/flow_model.py:32-295`, every kind the JAX
package builds:
  * `flow.model=resflow`: the bare residual flow, unconditioned, its
    parameters under the reference's `transforms.*` (INDM builds it
    without a wolf); the log-det is the flow's own;
  * `flow.model=wolf` with the preset's generator: the residual flow
    conditioned on h, or (`generator.flow.type` glow or macow) the
    multi-scale flows of `indm_torch.flows.wolf_glow` and `wolf_macow`,
    built with `inverse: true` so that encoding runs their reverse pass
    (`flow_model.py:224-231`) with an exact log-det; and the preset's
    discriminator (gaussian with a flow or normal prior, base, or
    categorical), whose KL is subtracted: `logdet_kl` = log|det| - KL.
`flow.actnorm` and `flow.squeeze` apply as in the JAX package (actnorm to
the residual flow only). The reverse direction draws h from the prior
(None for the base discriminator) and inverts the generator.
`update_lipschitz`, and `get_lipschitz_constants` (empty without a
residual flow).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from indm_torch.configs.wolf_presets import load_wolf_params
from indm_torch.flows import wolf as wolf_lib
from indm_torch.flows.resflow import IResBlock, ResidualFlow, squeeze, \
    unsqueeze


class _Generator(nn.Module):

  def __init__(self, flow):
    super().__init__()
    self.flow = flow


class FlowModel(nn.Module):
  """`kind` "resflow" (the bare flow, whose `transforms` are this module's
  own) or "wolf": `generator.flow` (a residual flow, Glow or MaCow) and
  `discriminator`, as in the reference WolfCore. `resflow` is the residual
  flow or None, `gen_module` the Glow or MaCow or None."""

  def __init__(self, config, generator=None, device=None):
    super().__init__()
    self.kind = config.flow.model
    if self.kind not in ("resflow", "wolf"):
      raise NotImplementedError(f"flow.model={self.kind!r}")
    self.squeeze = bool(config.flow.squeeze)
    img = config.data.image_size
    ch = config.data.num_channels
    if self.squeeze:
      img, ch = img // 2, ch * 4
    self.discriminator = None
    self.gen_kind = "resflow"
    cond_dim = None
    if self.kind == "wolf":
      wolf_params = load_wolf_params(config.flow.model_config)
      self.discriminator = wolf_lib.make_discriminator(wolf_params, img, ch,
                                                       generator, device)
      cond_dim = self.discriminator.dim
      self.gen_kind = wolf_params["generator"]["flow"].get("type", "resflow")
    if self.gen_kind != "resflow":
      self.generator = _Generator(self._multiscale(
          wolf_params["generator"]["flow"], ch, generator, device))
      if device != "meta":
        self._data_dependent_init(img, ch, generator)
      return
    n_blocks = tuple(int(b) for b in config.flow.nblocks.split("-"))
    f = config.flow
    flow = ResidualFlow(
        image_hw=img, in_ch=ch, n_blocks=n_blocks,
        intermediate_dim=f.intermediate_dim, activation_fn=f.act_fn,
        cond_dim=cond_dim, generator=generator, device=device,
        fused_block=bool(f.get("fused_block", False)),
        compute_dtype=flow_compute_dtype(config),
        mixed_precision=bool(f.get("mixed_precision", False)),
        unroll_terms=int(f.get("logdet_unroll", 0) or 0),
        actnorm=bool(f.actnorm), chain_bf16=bool(f.get("logdet_bf16", False)))
    if self.kind == "wolf":
      self.generator = _Generator(flow)
    else:
      # the reference's bare ResidualFlow: its keys at the root
      self.transforms = flow.transforms
      self.__dict__["_bare"] = flow

  @staticmethod
  def _multiscale(gp, ch, generator, device):
    """The preset's Glow or MaCow (`flow_model.py:92-104`)."""
    from indm_torch.flows import wolf_glow, wolf_macow  # noqa: F401
    gp = dict(gp)
    kind = gp.pop("type")
    gp.pop("inverse", None)
    ct = gp.pop("coupling_type", "conv")
    if ct != "conv":
      raise NotImplementedError(
          f"coupling_type {ct!r}: the JAX package asserts 'conv' "
          "(indm_tpu/flows/flow_model.py:95)")
    if "num_groups" in gp and gp.get("normalize") != "group_norm":
      gp.pop("num_groups")
    if gp["in_channels"] != ch:
      raise ValueError(
          f"the {kind} preset takes {gp['in_channels']} input channels, the "
          f"flow's input has {ch} (flow.squeeze): its layers are sized by "
          "the preset, and the JAX package fails on the shapes too")
    return wolf_glow.flow_by_name(kind).from_params(gp, generator, device)

  def _data_dependent_init(self, img, ch, generator):
    """The wolf's data-dependent init (`flow_model.py:106-120`): one
    forward on unit normal inputs (and h) of 8 images standardises every
    actnorm and weight-normalised conv."""
    from indm_torch.flows.wolf_glow import data_dependent_init
    gen = self.gen_module
    x = torch.randn(8, ch, img, img, generator=generator)
    h = None
    if gen.h_channels:
      shape = ((8, gen.h_channels, img, img) if gen.squeeze_h
               else (8, gen.h_channels))
      h = torch.randn(shape, generator=generator)
    with torch.no_grad(), data_dependent_init():
      gen(x, h)

  @property
  def resflow(self) -> Optional[ResidualFlow]:
    if self.kind == "resflow":
      return self._bare
    return self.generator.flow if self.gen_kind == "resflow" else None

  @property
  def gen_module(self):
    return None if self.gen_kind == "resflow" else self.generator.flow

  def gaussian(self) -> bool:
    """Whether h is drawn from a Gaussian posterior (one eps a sample)."""
    return isinstance(self.discriminator, wolf_lib.GaussianDiscriminator)


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
  eps [B, dim] (None without a Gaussian discriminator) and each
  iResBlock's (vareps, n), in run order (none for Glow and MaCow)."""
  enc_eps: Optional[torch.Tensor]
  blocks: List[Tuple[torch.Tensor, int]]


def _enc_eps(flow_model: FlowModel, b: int, generator, device):
  if not flow_model.gaussian():
    return None
  return torch.randn((b, flow_model.discriminator.dim), generator=generator,
                     device=device)


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
  enc_eps = _enc_eps(flow_model, b, generator, device)
  resflow = flow_model.resflow
  return FlowNoise(enc_eps, [] if resflow is None else resflow.sample_noise(
      (b, c, h, w), generator, host_rng, device))


def flow_forward(config, flow_model: Optional[FlowModel], x,
                 reverse: bool = False,
                 generator: Optional[torch.Generator] = None,
                 prior_eps: Optional[torch.Tensor] = None,
                 train: bool = False, noise: Optional[FlowNoise] = None,
                 host_rng: Optional[np.random.Generator] = None,
                 eval_logdet: bool = True, y: Optional[torch.Tensor] = None):
  """Reverse: latent x [B,C,H,W] -> image, with h sampled from the prior
  (`prior_eps` [B, dim] replaces the Gaussian prior's standard-normal draw,
  `y` the categorical prior's labels). Returns (image, None).

  Forward: image x -> (z, log|det| - KL [B]), the wolf branch's
  `logdet_kl` (the bare resflow's log|det|; Glow's and MaCow's exact).
  `noise` replaces the draws of `sample_flow_noise`; `y` are the class
  labels that the categorical discriminator encodes (it raises without
  them, as the JAX package does). With `train` the training estimator,
  and the encoder's BatchNorm running statistics move in place. Without
  it (`indm_tpu/flows/flow_model.py:180-250`, train=False) the evaluation
  estimator, the BatchNorm on its running statistics whatever the
  module's mode, nothing differentiable out; with no `noise` the draws
  come from a torch generator and a numpy generator both seeded 0 afresh
  in each call, so that every call draws the same, as the JAX package's
  `PRNGKey(0)` does (`generator` and `host_rng` are not read).

  Without `eval_logdet` (`flow_model.py:180-186`) no log-det is
  estimated: each iResBlock is x + g(x), the only draw is the encoder's
  posterior eps (`noise.enc_eps`; its blocks are not read), and the
  result is (z, None). With `train` the encoder's BatchNorm still takes
  the batch's statistics and moves its running ones, under no_grad too,
  as the FID step's second phase needs (`indm_tpu/joint.py:206-208`)."""
  if flow_model is None:
    return x, (None if reverse else torch.zeros(x.shape[0], device=x.device))
  gen = flow_model.gen_module
  if not reverse:
    if noise is None:
      if not train:
        generator = torch.Generator(device=x.device).manual_seed(0)
        host_rng = np.random.default_rng(0)
      noise = (sample_flow_noise(flow_model, x.shape, generator, host_rng,
                                 x.device) if eval_logdet else
               FlowNoise(_enc_eps(flow_model, x.shape[0], generator,
                                  x.device), []))
    if flow_model.squeeze:
      x = squeeze(x, 2)
    disc = flow_model.discriminator
    mode = disc is not None and disc.training
    if disc is not None:
      disc.train(mode and train)
    try:
      with torch.set_grad_enabled(train and torch.is_grad_enabled()):
        h, kl = (None, torch.zeros(x.shape[0], device=x.device)) \
            if disc is None else disc.sampling_and_kl(x, noise.enc_eps, y=y)
        if gen is not None:
          # built inverted: encoding is the module's reverse pass
          z, ld = gen(x, h if gen.h_channels else None, reverse=True)
          logdet = ld - kl
        elif eval_logdet:
          z, logpx = flow_model.resflow.fwdpass(x, h, noise.blocks, train)
          logdet = -logpx - kl
        else:
          z = flow_model.resflow.fwdpass_plain(x, h)
    finally:
      if disc is not None:
        disc.train(mode)
    if flow_model.squeeze:
      z = unsqueeze(z, 2)
    return z, (logdet if eval_logdet else None)
  if flow_model.squeeze:
    x = squeeze(x, 2)
  disc = flow_model.discriminator
  h = None if disc is None else disc.sample_from_prior(
      x.shape[0], generator, prior_eps, y=y)
  if gen is not None:
    with torch.no_grad():
      z, _ = gen(x, h if gen.h_channels else None)
  else:
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
  power-iteration state, and the projection is the identity (nothing at
  all without a residual flow)."""
  return flow_model


def get_lipschitz_constants(flow_model: Optional[FlowModel]) -> List[float]:
  """The operator-norm bound of every Lipschitz conv of the residual flow
  in layer order (`flow_model.py:253-279`): each output channel's L1 norm,
  its largest; a run of blocks the JAX package scans as one stack reports
  each conv's largest over the stack. Empty without a residual flow."""
  if flow_model is None or flow_model.resflow is None:
    return []
  out = []

  def scales(block):
    return [c.weight.detach().abs().sum(dim=(1, 2, 3)).max()
            for c in block.convs()]

  for t in flow_model.resflow.transforms:
    blocks = [b for b in t.chain if isinstance(b, IResBlock)]
    single = [scales(b) for b in blocks if not b.in_stack]
    stack = [scales(b) for b in blocks if b.in_stack]
    out += [float(v) for row in single[:1] for v in row]
    if stack:
      out += [float(max(col)) for col in zip(*stack)]
    out += [float(v) for row in single[1:] for v in row]
  return out
