"""Building blocks of the NCSN++ score net (PyTorch, NCHW).

Counterpart of `indm_tpu/models/layers.py` for the VP branches: the
activations, the DDPM initialiser, convs, the timestep embedding, NIN,
GroupNorm(+swish), the attention block and the BigGAN res block without
FIR. Submodule names (`GroupNorm_0`, `Conv_0`, `Dense_0`, `NIN_0`, ...)
follow the reference torch INDM so that its state_dict keys apply.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from indm_torch.ops import group_norm as gn_op


def swish(x):
  return x * torch.sigmoid(x)


def get_act(name: str):
  """The score net's activation; the VP configs use swish, the only one
  ported."""
  if name.lower() != "swish":
    raise NotImplementedError(f"activation {name} is not ported yet")
  return swish


def default_init_(weight: torch.Tensor, scale: float = 1.0,
                  generator: Optional[torch.Generator] = None):
  """DDPM initialiser: variance scaling, fan_avg, uniform. Works for
  conv [O, I, kh, kw], linear [out, in] and NIN [in, out] weights, whose
  fan_avg is the same either way round."""
  scale = 1e-10 if scale == 0 else scale
  receptive = weight[0, 0].numel() if weight.dim() > 2 else 1
  fan_avg = (weight.shape[0] + weight.shape[1]) * receptive / 2.0
  bound = math.sqrt(3.0 * scale / fan_avg)
  with torch.no_grad():
    weight.uniform_(-bound, bound, generator=generator)
  return weight


def conv2d(in_ch, out_ch, kernel, init_scale=1.0, generator=None,
           device=None) -> nn.Conv2d:
  conv = nn.Conv2d(in_ch, out_ch, kernel, padding=kernel // 2, device=device)
  if device != "meta":
    default_init_(conv.weight, init_scale, generator)
    nn.init.zeros_(conv.bias)
  return conv


def linear(in_dim, out_dim, generator=None, device=None) -> nn.Linear:
  lin = nn.Linear(in_dim, out_dim, device=device)
  if device != "meta":
    default_init_(lin.weight, 1.0, generator)
    nn.init.zeros_(lin.bias)
  return lin


def get_timestep_embedding(timesteps: torch.Tensor,
                           embedding_dim: int) -> torch.Tensor:
  """Sinusoidal embedding of [B] timesteps; embedding_dim (nf) is even."""
  half_dim = embedding_dim // 2
  emb = math.log(10000) / (half_dim - 1)
  emb = torch.exp(torch.arange(half_dim, dtype=torch.float32,
                               device=timesteps.device) * -emb)
  emb = timesteps.float()[:, None] * emb[None, :]
  return torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)


class NIN(nn.Module):
  """1x1 channel mixing with a [in, out] weight."""

  def __init__(self, in_dim, num_units, init_scale=0.1, generator=None,
               device=None):
    super().__init__()
    self.W = nn.Parameter(torch.empty(in_dim, num_units, device=device))
    self.b = nn.Parameter(torch.zeros(num_units, device=device))
    if device != "meta":
      default_init_(self.W, init_scale, generator)

  def forward(self, x):
    y = torch.einsum("bchw,cd->bdhw", x, self.W)
    return y + self.b[None, :, None, None]


class GroupNorm(nn.Module):
  """GroupNorm over NCHW with eps 1e-6, then `act` ("none" or "swish").

  `fused=True` (`model.fused_groupnorm`) routes through
  `indm_torch.ops.group_norm.GroupNormAct`: the Hopper kernels, forward and
  backward, on the card. Otherwise the statistics are the JAX package's default math
  (`indm_tpu/models/layers.py:287-308`): per-(sample, channel) moments
  folded into groups, variance E[x^2] - mean^2 clamped at 0."""

  def __init__(self, num_groups, num_channels, act="none", fused=False,
               eps=1e-6, device=None):
    super().__init__()
    if act not in gn_op.ACTS:
      raise ValueError(f"GroupNorm act must be one of {gn_op.ACTS}")
    self.num_groups = num_groups
    self.eps = eps
    self.act = act
    self.fused = fused
    self.weight = nn.Parameter(torch.ones(num_channels, device=device))
    self.bias = nn.Parameter(torch.zeros(num_channels, device=device))

  def forward(self, x):
    if self.fused:
      return gn_op.GroupNormAct.apply(x.contiguous(), self.weight, self.bias,
                                      self.num_groups, self.eps, self.act)
    b, c = x.shape[:2]
    xf = x.float()
    m1 = xf.mean(dim=(2, 3))
    m2 = (xf * xf).mean(dim=(2, 3))
    g1 = m1.reshape(b, self.num_groups, -1).mean(dim=-1)
    g2 = m2.reshape(b, self.num_groups, -1).mean(dim=-1)
    rstd = torch.rsqrt(torch.clamp(g2 - g1 * g1, min=0.0) + self.eps)
    gs = c // self.num_groups
    mul = torch.repeat_interleave(rstd, gs, dim=1) * self.weight[None, :]
    add = self.bias[None, :] - torch.repeat_interleave(g1, gs, dim=1) * mul
    y = xf * mul[:, :, None, None] + add[:, :, None, None]
    return swish(y) if self.act == "swish" else y


class AttnBlockpp(nn.Module):
  """Single-head self-attention over the H*W positions."""

  def __init__(self, channels, skip_rescale=False, init_scale=0.0,
               fused=False, generator=None, device=None):
    super().__init__()
    self.GroupNorm_0 = GroupNorm(min(channels // 4, 32), channels,
                                 fused=fused, device=device)
    kw = dict(generator=generator, device=device)
    self.NIN_0 = NIN(channels, channels, **kw)
    self.NIN_1 = NIN(channels, channels, **kw)
    self.NIN_2 = NIN(channels, channels, **kw)
    self.NIN_3 = NIN(channels, channels, init_scale=init_scale, **kw)
    self.skip_rescale = skip_rescale

  def forward(self, x):
    b, c, hh, ww = x.shape
    h = self.GroupNorm_0(x)
    q = self.NIN_0(h).reshape(b, c, hh * ww)
    k = self.NIN_1(h).reshape(b, c, hh * ww)
    v = self.NIN_2(h).reshape(b, c, hh * ww)
    w = torch.einsum("bcn,bcm->bnm", q, k) * (int(c) ** (-0.5))
    w = torch.softmax(w, dim=-1)
    h = torch.einsum("bnm,bcm->bcn", w, v).reshape(b, c, hh, ww)
    h = self.NIN_3(h)
    if not self.skip_rescale:
      return x + h
    return (x + h) / math.sqrt(2.0)


def dropout(x, rate: float, generator: Optional[torch.Generator] = None):
  """Inverted dropout with the mask drawn from `generator` (flax's
  `nn.Dropout` semantics: keep with probability 1 - rate, scale by
  1 / (1 - rate)). Rate 0 returns x."""
  if rate == 0.0:
    return x
  keep = 1.0 - rate
  mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
  return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))


def naive_upsample_2d(x):
  return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def naive_downsample_2d(x):
  return F.avg_pool2d(x, 2)


class ResnetBlockBigGANpp(nn.Module):
  """BigGAN res block with in-block nearest/average resampling (no FIR),
  its two swish activations fused into the GroupNorms. In train mode the
  second activation goes through dropout at `dropout`, its mask drawn from
  the generator passed to `forward`."""

  def __init__(self, in_ch, out_ch=None, temb_dim=None, up=False,
               down=False, skip_rescale=True, init_scale=0.0, fused=False,
               dropout=0.1, generator=None, device=None):
    super().__init__()
    out_ch = out_ch or in_ch
    kw = dict(generator=generator, device=device)
    self.GroupNorm_0 = GroupNorm(min(in_ch // 4, 32), in_ch, act="swish",
                                 fused=fused, device=device)
    self.Conv_0 = conv2d(in_ch, out_ch, 3, **kw)
    self.Dense_0 = (linear(temb_dim, out_ch, **kw) if temb_dim is not None
                    else None)
    self.GroupNorm_1 = GroupNorm(min(out_ch // 4, 32), out_ch, act="swish",
                                 fused=fused, device=device)
    self.Conv_1 = conv2d(out_ch, out_ch, 3, init_scale=init_scale, **kw)
    self.Conv_2 = (conv2d(in_ch, out_ch, 1, **kw)
                   if (in_ch != out_ch or up or down) else None)
    self.up, self.down = up, down
    self.skip_rescale = skip_rescale
    self.dropout = dropout

  def forward(self, x, temb=None, generator=None):
    h = self.GroupNorm_0(x)
    if self.up:
      h, x = naive_upsample_2d(h), naive_upsample_2d(x)
    elif self.down:
      h, x = naive_downsample_2d(h), naive_downsample_2d(x)
    h = self.Conv_0(h)
    if temb is not None:
      h = h + self.Dense_0(swish(temb))[:, :, None, None]
    h = self.GroupNorm_1(h)
    if self.training:
      h = dropout(h, self.dropout, generator)
    h = self.Conv_1(h)
    if self.Conv_2 is not None:
      x = self.Conv_2(x)
    if not self.skip_rescale:
      return x + h
    return (x + h) / math.sqrt(2.0)
