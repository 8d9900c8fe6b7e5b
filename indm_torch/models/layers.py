"""Building blocks of the NCSN++ score net (PyTorch, NCHW).

Counterpart of `indm_tpu/models/layers.py` for the VP and VE branches: the
activations, the DDPM initialiser, convs, the timestep and Gaussian
Fourier embeddings, NIN, GroupNorm(+swish), the attention block, the FIR
conv and resampling blocks, and the BigGAN res block with nearest/average
or FIR resampling. Submodule names (`GroupNorm_0`, `Conv_0`, `Dense_0`,
`NIN_0`, `Conv2d_0`, ...) follow the reference torch INDM so that its
state_dict keys apply.

`compute_dtype` (bfloat16 under `model.mixed_precision`, else None) follows
`indm_tpu/models/layers.py:50-70`: the convs and the temb projections
compute in it from float32 master weights (cuDNN and cuBLAS bfloat16
calls, float32 sums, the output in it); NIN and attention round their
operands to it and sum in float32, with float32 logits and softmax;
GroupNorm keeps float32 statistics and stores its output in it. A residual sum divided by sqrt(2) is float32, as JAX promotes it
(`np.sqrt(2.0)` is a float64 scalar).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from indm_torch.ops import group_norm as gn_op
from indm_torch.ops import upfirdn2d as fir_op


def swish(x):
  """x * sigmoid(x). In bfloat16 the sigmoid is 1 / (1 + exp(-x)) with
  each operation rounded, as XLA expands the JAX net's bfloat16 `logistic`
  (`jax.nn.silu` under `model.mixed_precision`)."""
  if x.dtype == torch.bfloat16:
    return x * torch.reciprocal(1 + torch.exp(-x))
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


def _to(x, dtype):
  return x if dtype is None else x.to(dtype)


class Conv2d(nn.Conv2d):
  """nn.Conv2d that computes in `compute_dtype` when one is set, as flax's
  `Conv(dtype=bfloat16)` does: input and weight cast to it, the conv's
  output in it, then the bias added in it (a second rounding)."""

  def __init__(self, *args, compute_dtype=None, **kwargs):
    super().__init__(*args, **kwargs)
    self.compute_dtype = compute_dtype

  def forward(self, x):
    cdt = self.compute_dtype
    if cdt is None:
      return super().forward(x)
    return (self._conv_forward(x.to(cdt), self.weight.to(cdt), None)
            + self.bias.to(cdt)[:, None, None])


class Linear(nn.Linear):
  """nn.Linear that computes in `compute_dtype` when one is set, as flax's
  `Dense(dtype=bfloat16)` does (the product's output, then the bias added,
  in that type)."""

  def __init__(self, *args, compute_dtype=None, **kwargs):
    super().__init__(*args, **kwargs)
    self.compute_dtype = compute_dtype

  def forward(self, x):
    cdt = self.compute_dtype
    if cdt is None:
      return super().forward(x)
    return F.linear(x.to(cdt), self.weight.to(cdt)) + self.bias.to(cdt)


def conv2d(in_ch, out_ch, kernel, init_scale=1.0, generator=None,
           device=None, compute_dtype=None) -> Conv2d:
  conv = Conv2d(in_ch, out_ch, kernel, padding=kernel // 2, device=device,
                compute_dtype=compute_dtype)
  if device != "meta":
    default_init_(conv.weight, init_scale, generator)
    nn.init.zeros_(conv.bias)
  return conv


def linear(in_dim, out_dim, generator=None, device=None,
           compute_dtype=None) -> Linear:
  lin = Linear(in_dim, out_dim, device=device, compute_dtype=compute_dtype)
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


class GaussianFourierProjection(nn.Module):
  """Gaussian Fourier features of log noise levels: [sin, cos] of
  x W 2 pi with the fixed buffer W ~ scale N(0, 1) of `embedding_size`
  (state_dict key `W`, as the reference's)."""

  def __init__(self, embedding_size=256, scale=1.0, generator=None,
               device=None):
    super().__init__()
    if device == "meta":
      w = torch.empty(embedding_size, device=device)
    else:
      w = torch.randn(embedding_size, generator=generator,
                      device=device) * scale
    self.register_buffer("W", w)

  def forward(self, x):
    # the JAX order, in float32: the arguments reach about 1e3 rad, where
    # one float32 step of the argument is about 6e-5 of the sine
    x_proj = x[:, None] * self.W[None, :] * 2 * math.pi
    return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], dim=-1)


def f32_product(a, b, dtype):
  """a and b rounded to `dtype` and held in float32 (their products are
  exact there), for a product summed in float32: the
  `preferred_element_type=float32` dots of the JAX net's NIN and
  attention."""
  return a.to(dtype).float(), b.to(dtype).float()


class NIN(nn.Module):
  """1x1 channel mixing with a [in, out] weight; with `compute_dtype` the
  operands are rounded to it, the product summed in float32, the bias
  added in float32 and the sum stored in it (`layers.py:168-172`)."""

  def __init__(self, in_dim, num_units, init_scale=0.1, generator=None,
               device=None, compute_dtype=None):
    super().__init__()
    self.W = nn.Parameter(torch.empty(in_dim, num_units, device=device))
    self.b = nn.Parameter(torch.zeros(num_units, device=device))
    self.compute_dtype = compute_dtype
    if device != "meta":
      default_init_(self.W, init_scale, generator)

  def forward(self, x):
    cdt = self.compute_dtype
    if cdt is None:
      return (torch.einsum("bchw,cd->bdhw", x, self.W)
              + self.b[None, :, None, None])
    y = torch.einsum("bchw,cd->bdhw", *f32_product(x, self.W, cdt))
    return (y + self.b[None, :, None, None]).to(cdt)


class GroupNorm(nn.Module):
  """GroupNorm over NCHW with eps 1e-6, then `act` ("none" or "swish").

  `fused=True` (`model.fused_groupnorm`) routes through
  `indm_torch.ops.group_norm.GroupNormAct`: the Hopper kernels, forward and
  backward, on the card; where no input needs a gradient, through its
  forward `group_norm_act` alone. Otherwise the statistics are the JAX
  package's default math
  (`indm_tpu/models/layers.py:287-308`): per-(sample, channel) moments
  folded into groups, variance E[x^2] - mean^2 clamped at 0."""

  def __init__(self, num_groups, num_channels, act="none", fused=False,
               eps=1e-6, device=None, compute_dtype=None):
    super().__init__()
    if act not in gn_op.ACTS:
      raise ValueError(f"GroupNorm act must be one of {gn_op.ACTS}")
    self.num_groups = num_groups
    self.eps = eps
    self.act = act
    self.fused = fused
    self.compute_dtype = compute_dtype
    self.weight = nn.Parameter(torch.ones(num_channels, device=device))
    self.bias = nn.Parameter(torch.zeros(num_channels, device=device))

  def forward(self, x):
    """With `compute_dtype` the statistics stay float32 and the output is
    stored in that type before the activation, which runs in it
    (`layers.py:255-308, 346-357`)."""
    cdt = self.compute_dtype
    if self.fused:
      args = (_to(x, cdt).contiguous(), self.weight, self.bias,
              self.num_groups, self.eps, self.act)
      if torch.is_grad_enabled() and any(
          t.requires_grad for t in args[:3]):
        return gn_op.GroupNormAct.apply(*args)
      # nothing to differentiate (sampling): the forward alone, without
      # the autograd Function's host cost
      return gn_op.group_norm_act(*args)
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
    y = _to(xf * mul[:, :, None, None] + add[:, :, None, None], cdt)
    return swish(y) if self.act == "swish" else y


class AttnBlockpp(nn.Module):
  """Single-head self-attention over the H*W positions."""

  def __init__(self, channels, skip_rescale=False, init_scale=0.0,
               fused=False, generator=None, device=None, compute_dtype=None):
    super().__init__()
    self.GroupNorm_0 = GroupNorm(min(channels // 4, 32), channels,
                                 fused=fused, device=device,
                                 compute_dtype=compute_dtype)
    kw = dict(generator=generator, device=device, compute_dtype=compute_dtype)
    self.NIN_0 = NIN(channels, channels, **kw)
    self.NIN_1 = NIN(channels, channels, **kw)
    self.NIN_2 = NIN(channels, channels, **kw)
    self.NIN_3 = NIN(channels, channels, init_scale=init_scale, **kw)
    self.skip_rescale = skip_rescale
    self.compute_dtype = compute_dtype

  def forward(self, x):
    """With `compute_dtype` both products take operands rounded to it and
    sum in float32: the logits, the softmax and the weighted sum are
    float32 (`layers.py:400-408`)."""
    b, c, hh, ww = x.shape
    cdt = self.compute_dtype
    h = self.GroupNorm_0(x)
    q = self.NIN_0(h).reshape(b, c, hh * ww)
    k = self.NIN_1(h).reshape(b, c, hh * ww)
    v = self.NIN_2(h).reshape(b, c, hh * ww)
    if cdt is not None:
      q, k = f32_product(q, k, cdt)
    w = torch.einsum("bcn,bcm->bnm", q, k) * (int(c) ** (-0.5))
    w = torch.softmax(w, dim=-1)
    if cdt is not None:
      w, v = f32_product(w, v, cdt)
    h = torch.einsum("bnm,bcm->bcn", w, v).reshape(b, c, hh, ww)
    h = self.NIN_3(h)
    return residual(x, h, self.skip_rescale, cdt)


def residual(x, h, skip_rescale: bool, compute_dtype=None):
  """x + h, divided by sqrt(2) with `skip_rescale`; in mixed precision that
  quotient is float32, as JAX promotes the bfloat16 sum by the float64
  scalar `np.sqrt(2.0)`."""
  if not skip_rescale:
    return x + h
  s = x + h
  return (s if compute_dtype is None else s.float()) / math.sqrt(2.0)


def dropout(x, rate: float, generator: Optional[torch.Generator] = None,
            fast: bool = False):
  """Inverted dropout with the mask drawn from `generator` (flax's
  `nn.Dropout` semantics: keep with probability 1 - rate, scale by
  1 / (1 - rate)). Rate 0 returns x.

  `fast` (`model.fast_dropout`, `indm_tpu/models/layers.py:84-114`) is the
  same dropout. On the TPU that switch draws the mask bits from XLA's
  hardware generator instead of threefry, which is cheaper there and
  equal in distribution only; the port draws its masks from the torch
  generator either way, so there is no second generator to switch to. What
  the switch also changes is kept: the kept values are multiplied by
  1 / (1 - rate) in x's own type instead of divided in it."""
  if rate == 0.0:
    return x
  keep = 1.0 - rate
  mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
  kept = (x * torch.tensor(1.0 / keep, dtype=x.dtype, device=x.device)
          if fast else x / keep)
  return torch.where(mask, kept, torch.zeros((), dtype=x.dtype,
                                             device=x.device))


class FIRConv2d(nn.Module):
  """StyleGAN2 conv with FIR up- or downsampling folded in: OIHW `weight`
  and `bias`, as the reference's `up_or_down_sampling.Conv2d`."""

  def __init__(self, in_ch, out_ch, kernel=3, up=False, down=False,
               resample_kernel=(1, 3, 3, 1), generator=None, device=None):
    super().__init__()
    assert not (up and down)
    self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel,
                                           device=device))
    self.bias = nn.Parameter(torch.zeros(out_ch, device=device))
    if device != "meta":
      default_init_(self.weight, 1.0, generator)
    self.up, self.down = up, down
    self.resample_kernel = tuple(resample_kernel)

  def forward(self, x):
    if self.up:
      x = fir_op.upsample_conv_2d(x, self.weight, k=self.resample_kernel)
    elif self.down:
      x = fir_op.conv_downsample_2d(x, self.weight, k=self.resample_kernel)
    else:
      x = F.conv2d(x, self.weight, padding=self.weight.shape[-1] // 2)
    return x + self.bias[None, :, None, None]


class Upsample(nn.Module):
  """FIR upsampling by 2, with the FIR conv (`Conv2d_0`) under
  `with_conv`. The nearest-neighbour variant belongs to the DDPM res
  block, which the port does not run."""

  def __init__(self, in_ch, out_ch=None, with_conv=False,
               fir_kernel=(1, 3, 3, 1), generator=None, device=None):
    super().__init__()
    if with_conv:
      self.Conv2d_0 = FIRConv2d(in_ch, out_ch or in_ch, 3, up=True,
                                resample_kernel=fir_kernel,
                                generator=generator, device=device)
    self.with_conv = with_conv
    self.fir_kernel = tuple(fir_kernel)

  def forward(self, x):
    if self.with_conv:
      return self.Conv2d_0(x)
    return fir_op.upsample_2d(x, self.fir_kernel, factor=2)


class Downsample(nn.Module):
  """FIR downsampling by 2, with the FIR conv (`Conv2d_0`) under
  `with_conv`: the input pyramid's resampling under
  `progressive_input='residual'`."""

  def __init__(self, in_ch, out_ch=None, with_conv=False,
               fir_kernel=(1, 3, 3, 1), generator=None, device=None):
    super().__init__()
    if with_conv:
      self.Conv2d_0 = FIRConv2d(in_ch, out_ch or in_ch, 3, down=True,
                                resample_kernel=fir_kernel,
                                generator=generator, device=device)
    self.with_conv = with_conv
    self.fir_kernel = tuple(fir_kernel)

  def forward(self, x):
    if self.with_conv:
      return self.Conv2d_0(x)
    return fir_op.downsample_2d(x, self.fir_kernel, factor=2)


def naive_upsample_2d(x):
  return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def naive_downsample_2d(x):
  return F.avg_pool2d(x, 2)


class ResnetBlockBigGANpp(nn.Module):
  """BigGAN res block with in-block nearest/average resampling, or FIR
  resampling of h and x with `fir` (`fir_kernel`), its two swish
  activations fused into the GroupNorms. In train mode the
  second activation goes through dropout at `dropout`, its mask drawn from
  the generator passed to `forward`."""

  def __init__(self, in_ch, out_ch=None, temb_dim=None, up=False,
               down=False, skip_rescale=True, init_scale=0.0, fused=False,
               dropout=0.1, fir=False, fir_kernel=(1, 3, 3, 1),
               generator=None, device=None, compute_dtype=None,
               fast_dropout=False):
    super().__init__()
    out_ch = out_ch or in_ch
    kw = dict(generator=generator, device=device, compute_dtype=compute_dtype)
    self.GroupNorm_0 = GroupNorm(min(in_ch // 4, 32), in_ch, act="swish",
                                 fused=fused, device=device,
                                 compute_dtype=compute_dtype)
    self.Conv_0 = conv2d(in_ch, out_ch, 3, **kw)
    self.Dense_0 = (linear(temb_dim, out_ch, **kw) if temb_dim is not None
                    else None)
    self.GroupNorm_1 = GroupNorm(min(out_ch // 4, 32), out_ch, act="swish",
                                 fused=fused, device=device,
                                 compute_dtype=compute_dtype)
    self.Conv_1 = conv2d(out_ch, out_ch, 3, init_scale=init_scale, **kw)
    self.Conv_2 = (conv2d(in_ch, out_ch, 1, **kw)
                   if (in_ch != out_ch or up or down) else None)
    self.up, self.down = up, down
    self.fir, self.fir_kernel = fir, tuple(fir_kernel)
    self.skip_rescale = skip_rescale
    self.dropout = dropout
    self.compute_dtype = compute_dtype
    self.fast_dropout = fast_dropout

  def forward(self, x, temb=None, generator=None):
    h = self.GroupNorm_0(x)
    if self.up:
      if self.fir:
        h = fir_op.upsample_2d(h, self.fir_kernel, factor=2)
        x = fir_op.upsample_2d(x, self.fir_kernel, factor=2)
      else:
        h, x = naive_upsample_2d(h), naive_upsample_2d(x)
    elif self.down:
      if self.fir:
        h = fir_op.downsample_2d(h, self.fir_kernel, factor=2)
        x = fir_op.downsample_2d(x, self.fir_kernel, factor=2)
      else:
        h, x = naive_downsample_2d(h), naive_downsample_2d(x)
    h = self.Conv_0(h)
    if temb is not None:
      h = h + self.Dense_0(swish(temb))[:, :, None, None]
    h = self.GroupNorm_1(h)
    if self.training:
      h = dropout(h, self.dropout, generator, self.fast_dropout)
    h = self.Conv_1(h)
    if self.Conv_2 is not None:
      x = self.Conv_2(x)
    return residual(x, h, self.skip_rescale, self.compute_dtype)
