"""Wolf VAE-flow pieces (PyTorch, NCHW): the Gaussian discriminator with its
global ResNet encoder (BatchNorm or GroupNorm) and its prior over h, a NICE
flow with its sampling and density passes or the standard normal; and
`make_discriminator` over the presets' whole matrix (the base and
categorical discriminators are in `indm_torch.flows.wolf_extras`).

Counterpart of `indm_tpu/flows/wolf.py:39-211, 275-599`. Module names
follow the reference torch INDM
(`discriminator.encoder.net.resnet{l}.main.{j}.{conv1,bn1,...}`, `gn1`,
`gn2` in the GroupNorm blocks, `discriminator.fc.linear`,
`discriminator.prior.flow.steps.{i}...`), so that
`indm_tpu/flows/convert.py` reads the state_dict.
"""

from __future__ import annotations

import collections
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# `indm_tpu/flows/wolf.py:27-31`
_ACTS = {"relu": F.relu, "elu": F.elu,
         "leaky_relu": lambda x: F.leaky_relu(x, 0.1)}


class _WeightNormParams(nn.Module):

  def __init__(self, in_f, out_f, generator=None, device=None):
    super().__init__()
    self.weight_v = nn.Parameter(torch.empty(out_f, in_f, device=device))
    self.weight_g = nn.Parameter(torch.empty(out_f, 1, device=device))
    self.bias = nn.Parameter(torch.zeros(out_f, device=device))
    if device != "meta":
      with torch.no_grad():
        self.weight_v.normal_(0.0, 0.05, generator=generator)
        self.weight_g.copy_(self.weight_v.norm(dim=1, keepdim=True))


class DenseWeightNorm(nn.Module):
  """Linear layer with w = g * v / ||v|| per output."""

  def __init__(self, in_f, out_f, generator=None, device=None):
    super().__init__()
    self.linear = _WeightNormParams(in_f, out_f, generator, device)

  def forward(self, x):
    p = self.linear
    w = p.weight_v * (p.weight_g / (p.weight_v.norm(dim=1, keepdim=True)
                                    + 1e-12))
    return x @ w.T + p.bias


def _linear(in_f, out_f, generator=None, device=None):
  lin = nn.Linear(in_f, out_f, device=device)
  if device != "meta":
    bound = 1.0 / in_f ** 0.5
    with torch.no_grad():
      lin.weight.uniform_(-bound, bound, generator=generator)
      lin.bias.zero_()
  return lin


class NICEMLPBlock(nn.Module):

  def __init__(self, in_f, out_f, hidden, activation="elu", generator=None,
               device=None):
    super().__init__()
    self.fc1 = _linear(in_f, hidden, generator, device)
    self.fc2 = _linear(hidden, hidden, generator, device)
    self.fc3 = DenseWeightNorm(hidden, out_f, generator, device)
    self.act = _ACTS[activation]

  def forward(self, x):
    return self.fc3(self.act(self.fc2(self.act(self.fc1(x)))))


def _conv(in_ch, out_ch, k, stride=1, bias=False, generator=None,
          device=None):
  """torch's conv3x3 / conv1x1 of the wolf ResNets: padding k // 2 at any
  stride; weights uniform in +-1/sqrt(fan_in) from `generator`."""
  conv = nn.Conv2d(in_ch, out_ch, k, stride=stride, padding=k // 2,
                   bias=bias, device=device)
  if device != "meta":
    bound = 1.0 / math.sqrt(in_ch * k * k)
    with torch.no_grad():
      conv.weight.uniform_(-bound, bound, generator=generator)
      if bias:
        conv.bias.zero_()
  return conv


class BatchNorm2d(nn.Module):
  """BatchNorm with flax `nn.BatchNorm`'s semantics (the JAX package's):
  train mode normalises with the batch mean and the biased variance
  E[x^2] - mean^2 and moves the running statistics by momentum 0.99 toward
  both (torch's `running_var` would take the unbiased variance); eval mode
  uses the running statistics. eps 1e-5. The buffer names are torch's."""

  def __init__(self, num_features, momentum=0.99, eps=1e-5, device=None):
    super().__init__()
    self.momentum = momentum
    self.eps = eps
    self.weight = nn.Parameter(torch.ones(num_features, device=device))
    self.bias = nn.Parameter(torch.zeros(num_features, device=device))
    self.register_buffer("running_mean",
                         torch.zeros(num_features, device=device))
    self.register_buffer("running_var", torch.ones(num_features,
                                                   device=device))
    self.register_buffer("num_batches_tracked",
                         torch.zeros((), dtype=torch.long, device=device))

  def forward(self, x):
    if self.training:
      mean = x.mean(dim=(0, 2, 3))
      var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
      with torch.no_grad():
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)
        self.num_batches_tracked += 1
    else:
      mean, var = self.running_mean, self.running_var
    mul = torch.rsqrt(var + self.eps) * self.weight
    return ((x - mean[None, :, None, None]) * mul[None, :, None, None]
            + self.bias[None, :, None, None])


def group_norm(num_groups, planes, device=None):
  """flax `nn.GroupNorm`'s (the JAX package's): eps 1e-6, the biased
  variance, a scale and a bias per channel."""
  return nn.GroupNorm(num_groups, planes, eps=1e-6, device=device)


class ResNetBlockBN(nn.Module):
  """Strided ResNet block with BatchNorm (`indm_tpu/flows/wolf.py:56-80`)."""

  norm_names = ("bn1", "bn2")

  def __init__(self, in_ch, planes, stride=1, generator=None, device=None,
               activation="elu", num_groups=None):
    super().__init__()
    kw = dict(generator=generator, device=device)
    self.act = _ACTS[activation]
    norm = self._norm(planes, num_groups, device)
    self.conv1 = _conv(in_ch, planes, 3, stride, **kw)
    setattr(self, self.norm_names[0], norm())
    self.conv2 = _conv(planes, planes, 3, **kw)
    setattr(self, self.norm_names[1], norm())
    self.downsample = None
    if stride != 1 or in_ch != planes:
      self.downsample = nn.Sequential(_conv(in_ch, planes, 1, stride, **kw),
                                      norm())

  @staticmethod
  def _norm(planes, num_groups, device):
    return lambda: BatchNorm2d(planes, device=device)

  def forward(self, x):
    n1, n2 = (getattr(self, n) for n in self.norm_names)
    h = self.act(n1(self.conv1(x)))
    h = n2(self.conv2(h))
    residual = x if self.downsample is None else self.downsample(x)
    return self.act(h + residual)


class ResNetBlockGN(ResNetBlockBN):
  """The GroupNorm variant (`indm_tpu/flows/wolf.py:83-107`)."""

  norm_names = ("gn1", "gn2")

  @staticmethod
  def _norm(planes, num_groups, device):
    return lambda: group_norm(num_groups, planes, device)


def conv_transpose(x, weight, stride):
  """flax `ConvTranspose` with SAME padding (`lax.conv_transpose`): x
  dilated by `stride`, padded (k + s - 2 split as lax splits it), then a
  VALID conv with the kernel as it stands (not flipped); output H * s.
  `weight` is [O, I, k, k], the flax HWIO kernel transposed."""
  k = weight.shape[-1]
  b, c, h, w = x.shape
  if stride > 1:
    xd = x.new_zeros(b, c, (h - 1) * stride + 1, (w - 1) * stride + 1)
    xd[:, :, ::stride, ::stride] = x
    x = xd
  pad_len = k + stride - 2
  lo = k - 1 if stride > k - 1 else (pad_len + 1) // 2
  hi = pad_len - lo
  return F.conv2d(F.pad(x, (lo, hi, lo, hi)), weight)


class _Deconv(nn.Module):
  """A transposed conv (no bias) as flax's `ConvTranspose` runs it
  (`conv_transpose`); weights uniform in +-1/sqrt(fan_in)."""

  def __init__(self, in_ch, out_ch, k, stride=1, generator=None,
               device=None):
    super().__init__()
    self.stride = stride
    self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k,
                                           device=device))
    if device != "meta":
      bound = 1.0 / math.sqrt(in_ch * k * k)
      with torch.no_grad():
        self.weight.uniform_(-bound, bound, generator=generator)

  def forward(self, x):
    return conv_transpose(x, self.weight, self.stride)


class DeResNetBlockGN(nn.Module):
  """Transposed-conv ResNet block with GroupNorm
  (`indm_tpu/flows/wolf.py:140-165`): the local encoders' upward blocks,
  stride 2 doubling H and W."""

  def __init__(self, in_ch, planes, num_groups, stride=1, generator=None,
               device=None, activation="elu"):
    super().__init__()
    kw = dict(generator=generator, device=device)
    self.act = _ACTS[activation]
    self.conv1 = _Deconv(in_ch, planes, 3, stride, **kw)
    self.gn1 = group_norm(num_groups, planes, device)
    self.conv2 = _Deconv(planes, planes, 3, **kw)
    self.gn2 = group_norm(num_groups, planes, device)
    self.downsample = None
    if stride != 1 or in_ch != planes:
      self.downsample = nn.Sequential(_Deconv(in_ch, planes, 1, stride, **kw),
                                      group_norm(num_groups, planes, device))

  def forward(self, x):
    h = self.act(self.gn1(self.conv1(x)))
    h = self.gn2(self.conv2(h))
    residual = x if self.downsample is None else self.downsample(x)
    return self.act(h + residual)


class _EncoderLevel(nn.Module):

  def __init__(self, in_ch, planes, generator=None, device=None,
               block=ResNetBlockBN, **kw):
    super().__init__()
    self.main = nn.Sequential(
        block(in_ch, planes, 1, generator, device, **kw),
        block(planes, planes, 2, generator, device, **kw))

  def forward(self, x):
    return self.main(x)


class GlobalResNetEncoderBN(nn.Module):
  """Per level a stride-1 and a stride-2 ResNet block, then a 1x1 conv,
  elu, and the NCHW flatten (`indm_tpu/flows/wolf.py:167-185`); with
  `num_groups` (one per level) the GroupNorm blocks: the JAX package's
  `GlobalResNetEncoderGN` (`:188-211`)."""

  def __init__(self, in_planes, hidden_planes, out_planes, generator=None,
               device=None, activation="elu", num_groups=None):
    super().__init__()
    mods = collections.OrderedDict()
    c = in_planes
    for level, planes in enumerate(hidden_planes):
      kw = dict(activation=activation)
      if num_groups is not None:
        kw.update(block=ResNetBlockGN, num_groups=num_groups[level])
      mods[f"resnet{level}"] = _EncoderLevel(c, planes, generator, device,
                                             **kw)
      c = planes
    mods["top"] = _conv(c, out_planes, 1, bias=True, generator=generator,
                        device=device)
    self.net = nn.Sequential(mods)

  def forward(self, x):
    return F.elu(self.net(x)).flatten(1)



class NICE1d(nn.Module):
  """1-D NICE coupling with an affine transform; `split_type` continuous
  (halves) or skip (even/odd), `order` up or down."""

  def __init__(self, in_features, hidden_features, split_type="continuous",
               order="up", activation="elu", generator=None, device=None):
    super().__init__()
    half = in_features // 2
    self.half = half
    self.split_type = split_type
    self.order = order
    self.net = NICEMLPBlock(half, half * 2, hidden_features, activation,
                            generator, device)

  def _split(self, z):
    if self.split_type == "continuous":
      return z[..., :self.half], z[..., self.half:]
    return z[..., 0::2], z[..., 1::2]

  def _unsplit(self, z1, z2):
    if self.split_type == "continuous":
      return torch.cat([z1, z2], dim=-1)
    return torch.stack([z1, z2], dim=-1).reshape(*z1.shape[:-1],
                                                 z1.shape[-1] * 2)

  def forward(self, z, reverse: bool = False):
    """(output, logdet [B]); the log-det is that of the forward map."""
    z1, z2 = self._split(z)
    zc, zp = (z1, z2) if self.order == "up" else (z2, z1)
    mu, log_scale = self.net(zc).chunk(2, dim=-1)
    scale = torch.sigmoid(log_scale + 2.0) + 1e-3
    logdet = torch.log(scale).sum(dim=-1)
    if reverse:
      zp, logdet = (zp - mu) / (scale + 1e-12), -logdet
    else:
      zp = scale * zp + mu
    z1, z2 = (zc, zp) if self.order == "up" else (zp, zc)
    return self._unsplit(z1, z2), logdet


class ActNorm1dFlow(nn.Module):

  def __init__(self, in_features, generator=None, device=None):
    super().__init__()
    self.log_scale = nn.Parameter(torch.empty(in_features, device=device))
    self.bias = nn.Parameter(torch.zeros(in_features, device=device))
    if device != "meta":
      with torch.no_grad():
        self.log_scale.normal_(0.0, 0.05, generator=generator)

  def forward(self, x, reverse: bool = False):
    logdet = self.log_scale.sum() * torch.ones(x.shape[0], device=x.device)
    if reverse:
      return (x - self.bias) / (torch.exp(self.log_scale) + 1e-8), -logdet
    return x * torch.exp(self.log_scale) + self.bias, logdet


class InvertibleLinearFlow(nn.Module):
  """y = x W^T. The reverse inverts the [d, d] weight in float64."""

  def __init__(self, in_features, generator=None, device=None):
    super().__init__()
    self.weight = nn.Parameter(torch.empty(in_features, in_features,
                                           device=device))
    if device != "meta":
      a = torch.randn(in_features, in_features, generator=generator)
      q, r = torch.linalg.qr(a)
      with torch.no_grad():
        self.weight.copy_(q * torch.sign(torch.diagonal(r))[None, :])

  def forward(self, x, reverse: bool = False):
    if reverse:
      w_inv = torch.linalg.inv(self.weight.double()).to(x.dtype)
      return x @ w_inv.T, None
    logdet = torch.linalg.slogdet(self.weight)[1]
    return x @ self.weight.T, logdet * torch.ones(x.shape[0], device=x.device)


class PriorFlowUnit(nn.Module):
  """Four couplings around an actnorm."""

  def __init__(self, in_features, hidden_features, activation="elu",
               generator=None, device=None):
    super().__init__()
    kw = dict(activation=activation, generator=generator, device=device)
    self.coupling1_up = NICE1d(in_features, hidden_features, "continuous",
                               "up", **kw)
    self.coupling1_dn = NICE1d(in_features, hidden_features, "continuous",
                               "down", **kw)
    self.actnorm = ActNorm1dFlow(in_features, generator, device)
    self.coupling2_up = NICE1d(in_features, hidden_features, "skip", "up",
                               **kw)
    self.coupling2_dn = NICE1d(in_features, hidden_features, "skip", "down",
                               **kw)

  def forward(self, x, reverse: bool = False):
    mods = [self.coupling1_up, self.coupling1_dn, self.actnorm,
            self.coupling2_up, self.coupling2_dn]
    return _run(reversed(mods) if reverse else mods, x, reverse)


def _run(mods, x, reverse):
  """Apply flow steps in turn: (output, summed log-det); the reverse
  direction (sampling) drops the log-dets."""
  logdet = None
  for m in mods:
    x, ld = m(x, reverse=reverse)
    if not reverse:
      logdet = ld if logdet is None else logdet + ld
  return x, logdet


class PriorFlowStep(nn.Module):
  """actnorm -> invertible linear -> unit."""

  def __init__(self, in_features, hidden_features, activation="elu",
               generator=None, device=None):
    super().__init__()
    self.actnorm = ActNorm1dFlow(in_features, generator, device)
    self.linear = InvertibleLinearFlow(in_features, generator, device)
    self.unit = PriorFlowUnit(in_features, hidden_features, activation,
                              generator, device)

  def forward(self, x, reverse: bool = False):
    mods = [self.actnorm, self.linear, self.unit]
    return _run(reversed(mods) if reverse else mods, x, reverse)


class PriorFlow(nn.Module):
  """The prior is built inverted: sampling (epsilon -> h) runs the steps
  backwards."""

  def __init__(self, num_steps, in_features, hidden_features,
               activation="elu", generator=None, device=None):
    super().__init__()
    self.steps = nn.ModuleList(
        PriorFlowStep(in_features, hidden_features, activation, generator,
                      device) for _ in range(num_steps))

  def sample_pass(self, epsilon):
    return _run(reversed(self.steps), epsilon, True)[0]

  def density(self, z):
    """z -> (epsilon, logdet [B]): the steps run forward."""
    return _run(self.steps, z, False)


class FlowPrior(nn.Module):

  def __init__(self, num_steps, in_features, hidden_features,
               activation="elu", generator=None, device=None):
    super().__init__()
    self.flow = PriorFlow(num_steps, in_features, hidden_features,
                          activation, generator, device)


class GaussianDiscriminator(nn.Module):
  """The Gaussian 'discriminator' of the wolf presets: the encoder (the
  global ResNet with BatchNorm, or GroupNorm with `encoder["num_groups"]`)
  and a weight-norm head give the posterior (mu, logvar) of the `dim`-wide
  h, whose prior is a NICE flow or, with `prior_type` "normal", the
  standard normal (`indm_tpu/flows/wolf.py:466-557`)."""

  def __init__(self, dim, encoder, prior_steps, prior_hidden,
               prior_activation="elu", generator=None, device=None,
               prior_type="flow"):
    super().__init__()
    self.dim = dim
    self.prior_type = prior_type
    self.encoder = GlobalResNetEncoderBN(
        encoder["in_planes"], encoder["hidden_planes"],
        encoder["out_planes"], generator, device,
        encoder.get("activation", "elu"), encoder.get("num_groups"))
    self.fc = DenseWeightNorm(encoder["in_dim"], 2 * dim, generator, device)
    if prior_type == "flow":
      self.prior = FlowPrior(prior_steps, dim, prior_hidden,
                             prior_activation, generator, device)
    elif prior_type != "normal":
      raise NotImplementedError(f"prior type {prior_type!r}")

  def forward(self, x):
    return self.fc(self.encoder(x)).chunk(2, dim=-1)

  def sampling_and_kl(self, x, eps: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None, y=None):
    """h = mu + std * eps from the posterior (eps ~ N(0, I) [B, dim] from
    `generator` unless given) and its KL term [B] (one posterior sample,
    as INDM draws). The labels `y` are not read."""
    mu, logvar = self(x)
    if eps is None:
      eps = torch.randn(mu.shape, generator=generator, device=mu.device)
    z = eps * torch.exp(0.5 * logvar) + mu
    return z, self.calc_kl(z, eps, mu, logvar)

  def calc_kl(self, z, eps, mu, logvar):
    """log q(z|x) - log p(z) with the flow prior's density
    (`indm_tpu/flows/wolf.py:530-549` at one sample), or the normal prior's
    closed form 0.5 sum(mu^2 + e^logvar - logvar - 1) (`:536-538`)."""
    if self.prior_type == "normal":
      from indm_torch.flows.wolf_extras import NormalPrior
      return NormalPrior.calc_kl(z, eps, mu, logvar)
    cc = math.log(math.pi * 2.0)
    log_posterior = ((logvar + eps ** 2).sum(dim=1) + cc * z.shape[1]) * -0.5
    epsilon, logdet = self.prior.flow.density(z)
    log_prior = ((epsilon ** 2).sum(dim=1) + cc * epsilon.shape[1]) * -0.5 \
        + logdet
    return log_posterior - log_prior

  def sample_from_prior(self, nsamples: int,
                        generator: Optional[torch.Generator] = None,
                        epsilon: Optional[torch.Tensor] = None, y=None):
    """h = the prior flow's sample pass of epsilon ~ N(0, I) [n, dim], or
    epsilon itself under the normal prior; `epsilon` replaces the draw."""
    device = self.fc.linear.weight_v.device
    if epsilon is None:
      epsilon = torch.randn(nsamples, self.dim, generator=generator,
                            device=device)
    epsilon = epsilon.to(device)
    if self.prior_type == "normal":
      return epsilon
    with torch.no_grad():
      return self.prior.flow.sample_pass(epsilon)


def make_discriminator(wolf_params, image_hw, in_ch, generator=None,
                       device=None):
  """The preset's discriminator for [B, in_ch, image_hw, image_hw] inputs
  over the whole matrix (`indm_tpu/flows/wolf.py:560-599`): "base" and
  "categorical" (`indm_torch.flows.wolf_extras`), or "gaussian" with the
  global BatchNorm or GroupNorm encoder and the flow or normal prior. The
  encoder's input planes and the head's width follow the input, as flax
  infers them."""
  from indm_torch.flows import wolf_extras
  d = wolf_params["discriminator"]
  kind = d["type"]
  if kind == "base":
    return wolf_extras.BaseDiscriminator()
  if kind == "categorical":
    return wolf_extras.CategoricalDiscriminator(
        d["num_events"], d["dim"], d.get("activation", "relu"),
        d.get("probs"), d.get("logits"), generator, device)
  if kind != "gaussian":
    raise ValueError(f"unknown discriminator type {kind!r}")
  prior = d["prior"]
  enc = dict(d["encoder"])
  if enc["type"] not in ("global_resnet_bn", "global_resnet_gn"):
    raise NotImplementedError(
        f"GaussianDiscriminator takes global encoders only, got "
        f"{enc['type']!r}, as in the JAX package")
  if enc["type"] == "global_resnet_bn":
    enc.pop("num_groups", None)
  hw = image_hw // 2 ** len(enc["hidden_planes"])
  enc.update(in_planes=in_ch, in_dim=enc["out_planes"] * hw * hw)
  return GaussianDiscriminator(d["dim"], enc, prior.get("num_steps", 0),
                               prior.get("hidden_features", 0),
                               prior.get("activation", "elu"), generator,
                               device, prior["type"])
