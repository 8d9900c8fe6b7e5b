"""Building blocks of the NCSN++ and DDPM score nets (PyTorch, NCHW).

Counterpart of `indm_tpu/models/layers.py`: the activations, the DDPM
initialiser, convs, the timestep, Gaussian Fourier and fixed
Fourier embeddings, NIN, GroupNorm followed by any activation, the
attention block, `Combine`, the nearest/average and FIR resampling blocks
with or without their conv, and the DDPM++ and BigGAN res blocks.
Submodule names (`GroupNorm_0`, `Conv_0`, `Dense_0`, `NIN_0`, `Conv2d_0`,
...) follow the reference torch INDM so that its state_dict keys apply.

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


def lrelu(x):
  return F.leaky_relu(x, 0.2)


ACTS = {"elu": F.elu, "relu": F.relu, "lrelu": lrelu, "swish": swish}


def get_act(name: str):
  """The score nets' activation by name (`indm_tpu/models/layers.py:24-35`):
  elu, relu, lrelu (slope 0.2) or swish."""
  try:
    return ACTS[name.lower()]
  except KeyError:
    raise NotImplementedError(f"activation {name} does not exist") from None


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
           device=None, compute_dtype=None, stride=1, padding=None) -> Conv2d:
  """A conv with the DDPM initialiser and a zero bias; `padding` defaults to
  kernel // 2 on each side, which is XLA's SAME at stride 1."""
  conv = Conv2d(in_ch, out_ch, kernel, stride=stride,
                padding=kernel // 2 if padding is None else padding,
                device=device, compute_dtype=compute_dtype)
  if device != "meta":
    default_init_(conv.weight, init_scale, generator)
    nn.init.zeros_(conv.bias)
  return conv


def conv1x1(in_ch, out_ch, **kw) -> Conv2d:
  return conv2d(in_ch, out_ch, 1, **kw)


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


def fixed_fourier_projection(x):
  """The fixed input Fourier features (`layers.py:194-201`): x and sin and
  cos of x 128 pi and x 256 pi along the channels (5 C in all)."""
  a, b = x * 128 * math.pi, x * 256 * math.pi
  return torch.cat([x, torch.sin(a), torch.cos(a), torch.sin(b),
                    torch.cos(b)], dim=1)


class FixedFourierProjection(nn.Module):
  """`fixed_fourier_projection` as the parameterless module that the
  reference keeps in the NCSN++ module list."""

  def forward(self, x):
    return fixed_fourier_projection(x)


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
  """GroupNorm over NCHW with eps 1e-6, then `act` ("none" or a name of
  `ACTS`), as `indm_tpu/models/layers.py:group_norm_act` applies it.

  `fused=True` (`model.fused_groupnorm`) routes through
  `indm_torch.ops.group_norm.GroupNormAct`: the Hopper kernels, forward and
  backward, on the card; where no input needs a gradient, through its
  forward `group_norm_act` alone. Only swish fuses into the kernel
  (`layers.py:226-233`); another activation follows the kernel's plain
  GroupNorm. Otherwise the statistics are the JAX package's default math
  (`indm_tpu/models/layers.py:287-308`): per-(sample, channel) moments
  folded into groups, variance E[x^2] - mean^2 clamped at 0."""

  def __init__(self, num_groups, num_channels, act="none", fused=False,
               eps=1e-6, device=None, compute_dtype=None):
    super().__init__()
    if act != "none" and act not in ACTS:
      raise ValueError(f"GroupNorm act must be 'none' or one of {list(ACTS)}")
    self.num_groups = num_groups
    self.eps = eps
    self.act = act
    self.kernel_act = act if act in gn_op.ACTS else "none"
    self.post_act = None if act in gn_op.ACTS else ACTS[act]
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
              self.num_groups, self.eps, self.kernel_act)
      if torch.is_grad_enabled() and any(
          t.requires_grad for t in args[:3]):
        y = gn_op.GroupNormAct.apply(*args)
      else:
        # nothing to differentiate (sampling): the forward alone, without
        # the autograd Function's host cost
        y = gn_op.group_norm_act(*args)
      return y if self.post_act is None else self.post_act(y)
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
    return y if self.act == "none" else ACTS[self.act](y)


class AttnBlockpp(nn.Module):
  """Single-head self-attention over the H*W positions. `num_groups`
  defaults to NCSN++'s min(C // 4, 32); DDPM's legacy block takes
  min(32, C), no skip rescale and `init_scale` 0 (`indm_tpu/models/
  ddpm.py:_LegacyAttn`)."""

  def __init__(self, channels, skip_rescale=False, init_scale=0.0,
               fused=False, generator=None, device=None, compute_dtype=None,
               num_groups=None):
    super().__init__()
    if num_groups is None:
      num_groups = min(channels // 4, 32)
    self.GroupNorm_0 = GroupNorm(num_groups, channels,
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


class Combine(nn.Module):
  """The input pyramid's combination (`layers.py:364-376`): a 1x1 conv
  (`Conv_0`) of the pyramid, then concatenated with h ("cat") or added to
  it ("sum")."""

  def __init__(self, dim1, dim2, method="cat", generator=None, device=None,
               compute_dtype=None):
    super().__init__()
    if method not in ("cat", "sum"):
      raise ValueError(f"Method {method} not recognized.")
    self.Conv_0 = conv1x1(dim1, dim2, generator=generator, device=device,
                          compute_dtype=compute_dtype)
    self.method = method

  def forward(self, x, y):
    h = self.Conv_0(x)
    return torch.cat([h, y], dim=1) if self.method == "cat" else h + y


class Upsample(nn.Module):
  """Upsampling by 2 (`layers.py:420-441`): with `fir`, FIR upsampling, or
  the FIR conv (`Conv2d_0`) under `with_conv`; without, nearest neighbour,
  then a 3x3 conv (`Conv_0`) under `with_conv`."""

  def __init__(self, in_ch, out_ch=None, with_conv=False, fir=False,
               fir_kernel=(1, 3, 3, 1), generator=None, device=None,
               compute_dtype=None):
    super().__init__()
    out_ch = out_ch or in_ch
    if with_conv and fir:
      self.Conv2d_0 = FIRConv2d(in_ch, out_ch, 3, up=True,
                                resample_kernel=fir_kernel,
                                generator=generator, device=device)
    elif with_conv:
      self.Conv_0 = conv2d(in_ch, out_ch, 3, generator=generator,
                           device=device, compute_dtype=compute_dtype)
    self.with_conv, self.fir = with_conv, fir
    self.fir_kernel = tuple(fir_kernel)

  def forward(self, x):
    if self.fir:
      if self.with_conv:
        return self.Conv2d_0(x)
      return fir_op.upsample_2d(x, self.fir_kernel, factor=2)
    h = naive_upsample_2d(x)
    return self.Conv_0(h) if self.with_conv else h


class Downsample(nn.Module):
  """Downsampling by 2 (`layers.py:444-467`): with `fir`, FIR downsampling,
  or the FIR conv (`Conv2d_0`) under `with_conv` (the residual input
  pyramid's); without, zero padding
  (0, 1) on H and W and a VALID stride-2 3x3 conv (`Conv_0`) under
  `with_conv`, else a 2x2 average."""

  def __init__(self, in_ch, out_ch=None, with_conv=False, fir=False,
               fir_kernel=(1, 3, 3, 1), generator=None, device=None,
               compute_dtype=None):
    super().__init__()
    out_ch = out_ch or in_ch
    if with_conv and fir:
      self.Conv2d_0 = FIRConv2d(in_ch, out_ch, 3, down=True,
                                resample_kernel=fir_kernel,
                                generator=generator, device=device)
    elif with_conv:
      self.Conv_0 = conv2d(in_ch, out_ch, 3, generator=generator,
                           device=device, compute_dtype=compute_dtype,
                           stride=2, padding=0)
    self.with_conv, self.fir = with_conv, fir
    self.fir_kernel = tuple(fir_kernel)

  def forward(self, x):
    if self.fir:
      if self.with_conv:
        return self.Conv2d_0(x)
      return fir_op.downsample_2d(x, self.fir_kernel, factor=2)
    if self.with_conv:
      return self.Conv_0(F.pad(x, (0, 1, 0, 1)))
    return naive_downsample_2d(x)


def naive_upsample_2d(x):
  return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def naive_downsample_2d(x):
  return F.avg_pool2d(x, 2)


class ResnetBlockDDPMpp(nn.Module):
  """DDPM++ res block (`layers.py:501-531`): GroupNorm and the activation,
  a 3x3 conv, the time embedding's projection added, GroupNorm and the
  activation, dropout in train mode (mask from the generator passed to
  `forward`), a 3x3 conv; where the width changes, the shortcut is a 3x3
  conv (`Conv_2`) under `conv_shortcut`, else NIN (`NIN_0`). The JAX net
  never sets `conv_shortcut`. `temb_dim` None: no projection (and no
  `Dense_0`)."""

  def __init__(self, in_ch, out_ch=None, temb_dim=None, act="swish",
               conv_shortcut=False, dropout=0.1, skip_rescale=False,
               init_scale=0.0, fused=False, generator=None, device=None,
               compute_dtype=None, fast_dropout=False):
    super().__init__()
    out_ch = out_ch or in_ch
    kw = dict(generator=generator, device=device, compute_dtype=compute_dtype)
    self.GroupNorm_0 = GroupNorm(min(in_ch // 4, 32), in_ch, act=act,
                                 fused=fused, device=device,
                                 compute_dtype=compute_dtype)
    self.Conv_0 = conv2d(in_ch, out_ch, 3, **kw)
    self.Dense_0 = (linear(temb_dim, out_ch, **kw) if temb_dim is not None
                    else None)
    self.GroupNorm_1 = GroupNorm(min(out_ch // 4, 32), out_ch, act=act,
                                 fused=fused, device=device,
                                 compute_dtype=compute_dtype)
    self.Conv_1 = conv2d(out_ch, out_ch, 3, init_scale=init_scale, **kw)
    if in_ch != out_ch:
      if conv_shortcut:
        self.Conv_2 = conv2d(in_ch, out_ch, 3, **kw)
      else:
        self.NIN_0 = NIN(in_ch, out_ch, **kw)
    self.shortcut = (None if in_ch == out_ch
                     else "Conv_2" if conv_shortcut else "NIN_0")
    self.act = get_act(act)
    self.skip_rescale = skip_rescale
    self.dropout = dropout
    self.compute_dtype = compute_dtype
    self.fast_dropout = fast_dropout

  def forward(self, x, temb=None, generator=None):
    h = self.Conv_0(self.GroupNorm_0(x))
    if temb is not None:
      h = h + self.Dense_0(self.act(temb))[:, :, None, None]
    h = self.GroupNorm_1(h)
    if self.training:
      h = dropout(h, self.dropout, generator, self.fast_dropout)
    h = self.Conv_1(h)
    if self.shortcut is not None:
      x = getattr(self, self.shortcut)(x)
    return residual(x, h, self.skip_rescale, self.compute_dtype)


class ResnetBlockBigGANpp(nn.Module):
  """BigGAN res block with in-block nearest/average resampling, or FIR
  resampling of h and x with `fir` (`fir_kernel`), each GroupNorm followed
  by `act` (swish fused into the kernel). In train mode the second
  activation goes through dropout at `dropout`, its mask drawn from the
  generator passed to `forward`. `temb_dim` None: no projection."""

  def __init__(self, in_ch, out_ch=None, temb_dim=None, up=False,
               down=False, skip_rescale=True, init_scale=0.0, fused=False,
               dropout=0.1, fir=False, fir_kernel=(1, 3, 3, 1),
               generator=None, device=None, compute_dtype=None,
               fast_dropout=False, act="swish"):
    super().__init__()
    out_ch = out_ch or in_ch
    kw = dict(generator=generator, device=device, compute_dtype=compute_dtype)
    self.GroupNorm_0 = GroupNorm(min(in_ch // 4, 32), in_ch, act=act,
                                 fused=fused, device=device,
                                 compute_dtype=compute_dtype)
    self.Conv_0 = conv2d(in_ch, out_ch, 3, **kw)
    self.Dense_0 = (linear(temb_dim, out_ch, **kw) if temb_dim is not None
                    else None)
    self.GroupNorm_1 = GroupNorm(min(out_ch // 4, 32), out_ch, act=act,
                                 fused=fused, device=device,
                                 compute_dtype=compute_dtype)
    self.Conv_1 = conv2d(out_ch, out_ch, 3, init_scale=init_scale, **kw)
    self.Conv_2 = (conv2d(in_ch, out_ch, 1, **kw)
                   if (in_ch != out_ch or up or down) else None)
    self.up, self.down = up, down
    self.fir, self.fir_kernel = fir, tuple(fir_kernel)
    self.act = get_act(act)
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
      h = h + self.Dense_0(self.act(temb))[:, :, None, None]
    h = self.GroupNorm_1(h)
    if self.training:
      h = dropout(h, self.dropout, generator, self.fast_dropout)
    h = self.Conv_1(h)
    if self.Conv_2 is not None:
      x = self.Conv_2(x)
    return residual(x, h, self.skip_rescale, self.compute_dtype)
