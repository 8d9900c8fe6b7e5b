"""Wolf VAE-flow pieces (PyTorch, NCHW): the Gaussian discriminator with its
global ResNet-BatchNorm encoder, and the NICE flow prior over h with its
sampling and density passes.

Counterpart of `indm_tpu/flows/wolf.py:39-80, 167-185, 275-557`. Module
names follow the reference torch INDM
(`discriminator.encoder.net.resnet{l}.main.{j}.{conv1,bn1,...}`,
`discriminator.fc.linear`, `discriminator.prior.flow.steps.{i}...`), so that
`indm_tpu/flows/convert.py` reads the state_dict.
"""

from __future__ import annotations

import collections
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# the prior's activation in INDM's wolf preset; the only one ported
_ACTS = {"elu": F.elu}


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


class ResNetBlockBN(nn.Module):
  """Strided ResNet block with BatchNorm (`indm_tpu/flows/wolf.py:56-80`)."""

  def __init__(self, in_ch, planes, stride=1, generator=None, device=None):
    super().__init__()
    kw = dict(generator=generator, device=device)
    self.conv1 = _conv(in_ch, planes, 3, stride, **kw)
    self.bn1 = BatchNorm2d(planes, device=device)
    self.conv2 = _conv(planes, planes, 3, **kw)
    self.bn2 = BatchNorm2d(planes, device=device)
    self.downsample = None
    if stride != 1 or in_ch != planes:
      self.downsample = nn.Sequential(_conv(in_ch, planes, 1, stride, **kw),
                                      BatchNorm2d(planes, device=device))

  def forward(self, x):
    h = F.elu(self.bn1(self.conv1(x)))
    h = self.bn2(self.conv2(h))
    residual = x if self.downsample is None else self.downsample(x)
    return F.elu(h + residual)


class _EncoderLevel(nn.Module):

  def __init__(self, in_ch, planes, generator=None, device=None):
    super().__init__()
    self.main = nn.Sequential(
        ResNetBlockBN(in_ch, planes, 1, generator, device),
        ResNetBlockBN(planes, planes, 2, generator, device))

  def forward(self, x):
    return self.main(x)


class GlobalResNetEncoderBN(nn.Module):
  """Per level a stride-1 and a stride-2 ResNet block, then a 1x1 conv,
  elu, and the NCHW flatten (`indm_tpu/flows/wolf.py:167-185`)."""

  def __init__(self, in_planes, hidden_planes, out_planes, generator=None,
               device=None):
    super().__init__()
    mods = collections.OrderedDict()
    c = in_planes
    for level, planes in enumerate(hidden_planes):
      mods[f"resnet{level}"] = _EncoderLevel(c, planes, generator, device)
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
  """The Gaussian 'discriminator' of the wolf preset: the encoder and a
  weight-norm head give the posterior (mu, logvar) of the `dim`-wide h,
  whose prior is a NICE flow (`indm_tpu/flows/wolf.py:466-557`)."""

  def __init__(self, dim, encoder, prior_steps, prior_hidden,
               prior_activation="elu", generator=None, device=None):
    super().__init__()
    self.dim = dim
    self.encoder = GlobalResNetEncoderBN(
        encoder["in_planes"], encoder["hidden_planes"],
        encoder["out_planes"], generator, device)
    self.fc = DenseWeightNorm(encoder["in_dim"], 2 * dim, generator, device)
    self.prior = FlowPrior(prior_steps, dim, prior_hidden, prior_activation,
                           generator, device)

  def forward(self, x):
    return self.fc(self.encoder(x)).chunk(2, dim=-1)

  def sampling_and_kl(self, x, eps: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None):
    """h = mu + std * eps from the posterior (eps ~ N(0, I) [B, dim] from
    `generator` unless given) and its KL term [B] (one posterior sample,
    as INDM draws)."""
    mu, logvar = self(x)
    if eps is None:
      eps = torch.randn(mu.shape, generator=generator, device=mu.device)
    z = eps * torch.exp(0.5 * logvar) + mu
    return z, self.calc_kl(z, eps, mu, logvar)

  def calc_kl(self, z, eps, mu, logvar):
    """log q(z|x) - log p(z) with the flow prior's density
    (`indm_tpu/flows/wolf.py:530-549` at one sample)."""
    cc = math.log(math.pi * 2.0)
    log_posterior = ((logvar + eps ** 2).sum(dim=1) + cc * z.shape[1]) * -0.5
    epsilon, logdet = self.prior.flow.density(z)
    log_prior = ((epsilon ** 2).sum(dim=1) + cc * epsilon.shape[1]) * -0.5 \
        + logdet
    return log_posterior - log_prior

  def sample_from_prior(self, nsamples: int,
                        generator: Optional[torch.Generator] = None,
                        epsilon: Optional[torch.Tensor] = None):
    """h = prior flow sample pass of epsilon ~ N(0, I) [n, dim]; `epsilon`
    replaces the draw."""
    device = self.prior.flow.steps[0].linear.weight.device
    if epsilon is None:
      epsilon = torch.randn(nsamples, self.dim, generator=generator,
                            device=device)
    with torch.no_grad():
      return self.prior.flow.sample_pass(epsilon.to(device))


def make_discriminator(wolf_params, image_hw, in_ch, generator=None,
                       device=None):
  """The preset's discriminator for [B, in_ch, image_hw, image_hw] inputs
  (the encoder's input planes and the head's width follow the input, as
  flax infers them)."""
  d = wolf_params["discriminator"]
  prior = d.get("prior", {})
  enc = d.get("encoder", {})
  if d["type"] != "gaussian" or prior.get("type") != "flow":
    raise NotImplementedError(
        f"only the gaussian discriminator with a flow prior is ported, got "
        f"{d['type']!r} / {prior.get('type')!r}")
  if enc.get("type") != "global_resnet_bn" or enc.get("activation") != "elu":
    raise NotImplementedError(
        f"only the global_resnet_bn encoder with elu is ported, got "
        f"{enc.get('type')!r} / {enc.get('activation')!r}")
  hw = image_hw // 2 ** len(enc["hidden_planes"])
  enc = dict(enc, in_planes=in_ch, in_dim=enc["out_planes"] * hw * hw)
  return GaussianDiscriminator(d["dim"], enc,
                               prior["num_steps"], prior["hidden_features"],
                               prior.get("activation", "elu"), generator,
                               device)
