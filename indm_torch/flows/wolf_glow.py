"""The wolf presets' Glow generator and the multi-scale architecture it
shares with MaCow (PyTorch, NCHW).

Counterpart of `indm_tpu/flows/wolf_glow.py:30-705`: the flow registry,
`squeeze2d`/`split2d` and their inverses, the weight-normalised conv, the
NICE conv block with its `normalize` choices, the local and global linear
cond nets, `ActNorm2dFlow`, `Conv1x1Flow`, the five coupling transforms,
`NICE2d`, `GlowUnit`, `GlowStep`, `MultiScalePrior` and `Glow`. Every module
takes (x, h=None, reverse=False) and returns (out, logdet [B]), the
log-det of the map it ran.

Module names follow the reference wolf flows that the JAX docstrings cite
(`blocks.{i}.steps.{j}` in an external level, `blocks.{i}.layers.{l}.{j}`
and `blocks.{i}.priors.{l}` in an internal one, `actnorm`, `conv1x1`,
`unit.coupling1_up.net.conv1`, the weight-normalised `conv3.conv.weight_v`
and `weight_g`), and `indm_torch.convert` carries the JAX parameters over
by them.

Initialisation keeps the wolf's data-dependent protocol
(`indm_tpu/flows/flow_model.py:106-120`): inside `data_dependent_init()` one
forward standardises the output of every `ActNorm2dFlow` and
`Conv2dWeightNorm` per channel (the coupling blocks' last convs to 0), as
flax's `init` does.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from indm_torch.flows.resflow import squeeze as squeeze2d
from indm_torch.flows.resflow import unsqueeze as unsqueeze2d
from indm_torch.flows.wolf import _ACTS, BatchNorm2d, group_norm

_FLOW_REGISTRY = {}


def register_flow(name):
  def _reg(cls):
    _FLOW_REGISTRY[name] = cls
    return cls
  return _reg


def flow_by_name(name):
  return _FLOW_REGISTRY[name]


def split2d(x, z1_channels: int):
  return x[:, :z1_channels], x[:, z1_channels:]


def unsplit2d(xs):
  return torch.cat(xs, dim=1)


_INIT = [False]


@contextlib.contextmanager
def data_dependent_init():
  """Within it, each `ActNorm2dFlow` and `Conv2dWeightNorm` sets its
  parameters from the batch it sees (no gradient), then runs on them."""
  _INIT[0] = True
  try:
    yield
  finally:
    _INIT[0] = False


def _stats(y):
  """Per-channel mean and population std of [B, C, H, W]."""
  return y.mean(dim=(0, 2, 3)), y.std(dim=(0, 2, 3), unbiased=False)


def _normal(t, std, generator):
  if t.device.type != "meta":
    with torch.no_grad():
      t.normal_(0.0, std, generator=generator)


def _conv_param(out_ch, in_ch, kh, kw, generator, device):
  """A conv kernel [O, I, kh, kw], lecun-normal as flax's `nn.Conv`."""
  w = nn.Parameter(torch.empty(out_ch, in_ch, kh, kw, device=device))
  _normal(w, (in_ch * kh * kw) ** -0.5, generator)
  return w


class _Conv(nn.Module):
  """flax `nn.Conv` with SAME (or VALID) padding at stride 1."""

  def __init__(self, in_ch, out_ch, kernel, bias=False, padding="SAME",
               generator=None, device=None):
    super().__init__()
    kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
    self.pad = ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2) \
        if padding == "SAME" else (0, 0, 0, 0)
    self.weight = _conv_param(out_ch, in_ch, kh, kw, generator, device)
    self.bias = (nn.Parameter(torch.zeros(out_ch, device=device)) if bias
                 else None)

  def forward(self, x):
    return F.conv2d(F.pad(x, self.pad), self.weight, self.bias)


class _WNConv(nn.Module):

  def __init__(self, in_ch, out_ch, kh, kw, generator=None, device=None):
    super().__init__()
    self.weight_v = nn.Parameter(torch.empty(out_ch, in_ch, kh, kw,
                                             device=device))
    _normal(self.weight_v, 0.05, generator)
    self.weight_g = nn.Parameter(torch.empty(out_ch, 1, 1, 1, device=device))
    if device != "meta":
      with torch.no_grad():
        self.weight_g.copy_(self.vnorm()[:, None, None, None])
    self.bias = nn.Parameter(torch.zeros(out_ch, device=device))

  def vnorm(self):
    return (self.weight_v ** 2).sum(dim=(1, 2, 3)).sqrt() + 1e-12


class Conv2dWeightNorm(nn.Module):
  """w = g v / ||v|| per output channel, SAME padding, a bias
  (`indm_tpu/flows/wolf_glow.py:70-106`). Under `data_dependent_init` its
  output is standardised to `init_scale` (0: the output is 0)."""

  def __init__(self, in_ch, out_ch, kernel=(3, 3), init_scale=1.0,
               generator=None, device=None):
    super().__init__()
    kh, kw = kernel
    self.pad = ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2)
    self.init_scale = init_scale
    self.conv = _WNConv(in_ch, out_ch, kh, kw, generator, device)

  def weight(self):
    c = self.conv
    return c.weight_v * (c.weight_g.flatten() / c.vnorm())[:, None, None,
                                                           None]

  def forward(self, x):
    x = F.pad(x, self.pad)
    if _INIT[0]:
      with torch.no_grad():
        mean, std = _stats(F.conv2d(x, self.conv.weight_v))
        inv = self.init_scale / (std + 1e-6)
        self.conv.weight_g.copy_((self.conv.vnorm() * inv)[:, None, None,
                                                            None])
        self.conv.bias.copy_(-mean * inv)
    return F.conv2d(x, self.weight(), self.conv.bias)


class NICEConvBlock(nn.Module):
  """conv3 -> act -> conv1 (+ h) -> act -> weight-norm conv3, with the norm
  after each of the first two convs (`wolf_glow.py:109-148`): none,
  "batch_norm" (flax's, `indm_torch.flows.wolf.BatchNorm2d`) or
  "group_norm". "instance_norm" raises: the JAX block names both norms'
  parameters alike, which flax refuses (NameInUseError)."""

  def __init__(self, in_ch, out_channels, hidden_channels,
               activation="relu", normalize=None, num_groups=None,
               generator=None, device=None):
    super().__init__()
    self.act = _ACTS[activation]
    kw = dict(generator=generator, device=device)
    self.conv1 = _Conv(in_ch, hidden_channels, 3, **kw)
    self.conv2 = _Conv(hidden_channels, hidden_channels, 1, **kw)
    self.conv3 = Conv2dWeightNorm(hidden_channels, out_channels, (3, 3),
                                  init_scale=0.0, **kw)
    if normalize is None:
      self.norm1 = self.norm2 = None
    elif normalize == "batch_norm":
      self.norm1 = BatchNorm2d(hidden_channels, device=device)
      self.norm2 = BatchNorm2d(hidden_channels, device=device)
    elif normalize == "group_norm":
      self.norm1 = group_norm(num_groups, hidden_channels, device)
      self.norm2 = group_norm(num_groups, hidden_channels, device)
    elif normalize == "instance_norm":
      raise NotImplementedError(
          "normalize='instance_norm' fails in the JAX package too: its "
          "NICEConvBlock creates the parameter in_scale_<C> twice (flax "
          "NameInUseError)")
    else:
      raise ValueError(normalize)

  def forward(self, x, h=None):
    norm1 = self.norm1 or (lambda y: y)
    norm2 = self.norm2 or (lambda y: y)
    out = self.act(norm1(self.conv1(x)))
    out = norm2(self.conv2(out))
    if h is not None:
      out = out + h
    return self.conv3(self.act(out))


class LocalLinearCondNet(nn.Module):
  """A 3x3 conv on a spatial conditioning map (`wolf_glow.py:151-157`)."""

  def __init__(self, h_channels, out_channels, generator=None, device=None):
    super().__init__()
    self.conv = _Conv(h_channels, out_channels, 3, bias=True,
                      generator=generator, device=device)

  def forward(self, h):
    return self.conv(h)


class GlobalLinearCondNet(nn.Module):
  """A dense layer on a global vector, broadcast over H and W
  (`wolf_glow.py:160-168`)."""

  def __init__(self, h_channels, out_channels, generator=None, device=None):
    super().__init__()
    self.linear = nn.Linear(h_channels, out_channels, device=device)
    _normal(self.linear.weight, h_channels ** -0.5, generator)
    if device != "meta":
      with torch.no_grad():
        self.linear.bias.zero_()

  def forward(self, h):
    return self.linear(h)[:, :, None, None]


def make_cond_net(h_type, h_channels, out_channels, generator=None,
                  device=None):
  if h_type is None:
    return None
  if h_type == "local_linear":
    return LocalLinearCondNet(h_channels, out_channels, generator, device)
  if h_type == "global_linear":
    return GlobalLinearCondNet(h_channels, out_channels, generator, device)
  raise NotImplementedError(f"h_type {h_type}")


class ActNorm2dFlow(nn.Module):
  """Per-channel affine with log-det H*W*sum(log_scale)
  (`wolf_glow.py:171-201`); under `data_dependent_init` the output of the
  direction it runs is standardised."""

  def __init__(self, in_channels, generator=None, device=None):
    super().__init__()
    self.log_scale = nn.Parameter(torch.empty(in_channels, device=device))
    _normal(self.log_scale, 0.05, generator)
    self.bias = nn.Parameter(torch.zeros(in_channels, device=device))

  def forward(self, x, h=None, reverse: bool = False):
    if _INIT[0]:
      with torch.no_grad():
        mean, std = _stats(x)
        std = std + 1e-6
        if reverse:
          self.log_scale.copy_(torch.log(std))
          self.bias.copy_(mean)
        else:
          self.log_scale.copy_(-torch.log(std))
          self.bias.copy_(-mean / std)
    ls, b = self.log_scale[:, None, None], self.bias[:, None, None]
    ld = self.log_scale.sum() * (x.shape[2] * x.shape[3])
    if not reverse:
      return x * torch.exp(ls) + b, ld.expand(x.shape[0])
    return (x - b) / (torch.exp(ls) + 1e-8), (-ld).expand(x.shape[0])


class Conv1x1Flow(nn.Module):
  """The invertible 1x1 conv y = W x (`wolf_glow.py:204-222`); the reverse
  applies inv(W) with log-det log|det inv(W)| per pixel."""

  def __init__(self, in_channels, generator=None, device=None):
    super().__init__()
    self.weight = nn.Parameter(torch.empty(in_channels, in_channels,
                                           device=device))
    if device != "meta":
      a = torch.randn(in_channels, in_channels, generator=generator)
      q, r = torch.linalg.qr(a)
      with torch.no_grad():
        self.weight.copy_(q * torch.sign(torch.diagonal(r))[None, :])

  def forward(self, x, h=None, reverse: bool = False):
    w = torch.linalg.inv(self.weight) if reverse else self.weight
    ld = torch.linalg.slogdet(w)[1] * (x.shape[2] * x.shape[3])
    return F.conv2d(x, w[:, :, None, None]), ld.expand(x.shape[0])


# -- coupling transforms (`wolf_glow.py:232-346`); params [B, k*C, H, W] ---


def _bsum(t):
  return t.flatten(1).sum(1)


def _affine(params, zp, reverse, alpha):
  mu, log_scale = params.chunk(2, dim=1)
  scale = torch.sigmoid(log_scale + 2.0) + 1e-3
  if not reverse:
    return scale * zp + mu, _bsum(torch.log(scale))
  return (zp - mu) / (scale + 1e-12), -_bsum(torch.log(scale))


def _additive(params, zp, reverse, alpha):
  out = zp + params if not reverse else zp - params
  return out, zp.new_zeros(zp.shape[0])


def _relu_transform(params, zp, reverse, alpha):
  mu, log_scale = params.chunk(2, dim=1)
  scale = torch.sigmoid(log_scale + 2.0)
  zero = torch.zeros_like(zp)
  if not reverse:
    out = torch.where(zp >= 0, zp, zp * scale) + mu
    ld_el = torch.where(zp >= 0, zero, torch.log(scale))
  else:
    z = zp - mu
    out = torch.where(z >= 0, z, z / scale)
    ld_el = -torch.where(z >= 0, zero, torch.log(scale))
  return out, _bsum(ld_el)


_NLSQ_LOG_A = math.log(8 * math.sqrt(3) / 9 - 0.05)


def _nlsq(params, zp, reverse, alpha):
  """y = a + b z + c / (1 + (d z + g)^2); the inverse solves the cubic by
  the hyperbolic method in float32, as the JAX package does."""
  a, logb, cprime, logd, g = params.chunk(5, dim=1)
  logb = logb * 0.4
  cprime = cprime * 0.3
  logd = logd * 0.4
  c = torch.exp(_NLSQ_LOG_A + logb - logd) * torch.tanh(cprime)
  b = torch.exp(logb)
  d = torch.exp(logd)
  if not reverse:
    arg = d * zp + g
    denom = arg ** 2 + 1.0
    cd = c / denom
    return b * zp + a + cd, _bsum(torch.log(b - 2.0 * cd * d * arg / denom))
  z = zp
  aa = -b * d ** 2
  bb = (z - a) * d ** 2 - 2.0 * b * d * g
  cc = (z - a) * 2.0 * d * g - b * (1.0 + g ** 2)
  dd = (z - a) * (1.0 + g ** 2) - c
  p = (3.0 * aa * cc - bb ** 2) / (3.0 * aa ** 2)
  q = (2.0 * bb ** 3 - 9.0 * aa * bb * cc + 27.0 * aa ** 2 * dd) \
      / (27.0 * aa ** 3)
  absp = torch.abs(p) + 1e-12
  t_neg = (-2.0 * torch.sign(q) * torch.sqrt(absp / 3.0)
           * torch.cosh(torch.acosh(
               torch.abs(-3.0 * torch.abs(q) / (2.0 * p)
                         * torch.sqrt(3.0 / absp) - 1.0) + 1.0) / 3.0))
  t_pos = (-2.0 * torch.sqrt(absp / 3.0)
           * torch.sinh(torch.asinh(
               3.0 * q / (2.0 * p) * torch.sqrt(3.0 / absp)) / 3.0))
  t = torch.where(p > 0, t_pos, t_neg)
  x = t - bb / (3.0 * aa)
  arg = d * x + g
  denom = arg ** 2 + 1.0
  return x, -_bsum(torch.log(b - 2.0 * c / denom * d * arg / denom))


def _symm_elu(params, zp, reverse, alpha):
  """y = z - sign(z) s (e^-|z| - 1) + mu, s = tanh(log_scale / 2); the
  reverse applies the mirrored form and reports no log-det, as the
  reference does."""
  mu, log_scale = params.chunk(2, dim=1)
  scale = torch.tanh(log_scale * 0.5)
  if not reverse:
    tmp = torch.exp(-torch.abs(zp))
    out = zp - torch.sign(zp) * scale * (tmp - 1.0) + mu
    return out, _bsum(torch.log(scale * tmp + 1.0))
  out = -torch.sign(zp) * scale * (torch.exp(-torch.abs(zp)) - 1.0) + mu
  return out, zp.new_zeros(zp.shape[0])


TRANSFORMS = {
    "affine": (_affine, 2),
    "additive": (_additive, 1),
    "relu": (_relu_transform, 2),
    "nlsq": (_nlsq, 5),
    "symm_elu": (_symm_elu, 2),
}


class NICE2d(nn.Module):
  """The 2-D NICE coupling on a channel split (`wolf_glow.py:360-414`):
  "continuous" halves or "skip" (even/odd channels; continuous for an odd
  count), `order` up or down, `factor` the share of channels transformed."""

  def __init__(self, in_channels, hidden_channels=None, h_channels=0,
               split_type="continuous", order="up", factor=2,
               transform="affine", alpha=1.0, h_type=None,
               activation="relu", normalize=None, num_groups=None,
               generator=None, device=None):
    super().__init__()
    if split_type == "skip":
      assert factor == 2
      if in_channels % 2 == 1:
        split_type = "continuous"
    self.split_type = split_type
    self.order = order
    self.alpha = alpha
    out_channels = in_channels // factor
    in_ch = in_channels - out_channels
    self.z1_channels = in_ch if order == "up" else out_channels
    self.tfn, mult = TRANSFORMS[transform]
    hidden = hidden_channels or min(8 * in_channels, 512)
    self.net = NICEConvBlock(in_ch, out_channels * mult, hidden, activation,
                             normalize, num_groups, generator, device)
    self.h_net = make_cond_net(h_type, h_channels, hidden, generator, device)

  def _split(self, z):
    if self.split_type == "continuous":
      return split2d(z, self.z1_channels)
    return z[:, 0::2], z[:, 1::2]

  def _unsplit(self, z1, z2):
    if self.split_type == "continuous":
      return unsplit2d([z1, z2])
    return torch.stack([z1, z2], dim=2).flatten(1, 2)

  def forward(self, z, h=None, reverse: bool = False):
    z1, z2 = self._split(z)
    zc, zp = (z1, z2) if self.order == "up" else (z2, z1)
    hc = self.h_net(h) if self.h_net is not None else None
    zp, ld = self.tfn(self.net(zc, hc), zp, reverse, self.alpha)
    z1, z2 = (zc, zp) if self.order == "up" else (zp, zc)
    return self._unsplit(z1, z2), ld


def run_flows(mods, x, h, reverse):
  """Each module in turn (backwards under `reverse`), the log-dets
  summed."""
  ld_total = x.new_zeros(x.shape[0])
  for m in (reversed(mods) if reverse else mods):
    x, ld = m(x, h=h, reverse=reverse)
    ld_total = ld_total + ld
  return x, ld_total


class GlowUnit(nn.Module):
  """coupling (continuous up, down) -> actnorm -> coupling (skip up, down)
  (`wolf_glow.py:422-466`)."""

  def __init__(self, in_channels, generator=None, device=None, **kw):
    super().__init__()
    nkw = dict(in_channels=in_channels, generator=generator, device=device,
               **kw)
    self.coupling1_up = NICE2d(split_type="continuous", order="up", **nkw)
    self.coupling1_dn = NICE2d(split_type="continuous", order="down", **nkw)
    self.actnorm = ActNorm2dFlow(in_channels, generator, device)
    self.coupling2_up = NICE2d(split_type="skip", order="up", **nkw)
    self.coupling2_dn = NICE2d(split_type="skip", order="down", **nkw)

  def forward(self, x, h=None, reverse: bool = False):
    return run_flows([self.coupling1_up, self.coupling1_dn, self.actnorm,
                      self.coupling2_up, self.coupling2_dn], x, h, reverse)


class GlowStep(nn.Module):
  """actnorm -> 1x1 conv -> Glow unit (`wolf_glow.py:469-509`)."""

  def __init__(self, in_channels, generator=None, device=None, **kw):
    super().__init__()
    self.actnorm = ActNorm2dFlow(in_channels, generator, device)
    self.conv1x1 = Conv1x1Flow(in_channels, generator, device)
    self.unit = GlowUnit(in_channels, generator, device, **kw)

  def forward(self, x, h=None, reverse: bool = False):
    return run_flows([self.actnorm, self.conv1x1, self.unit], x, h, reverse)


class MultiScalePrior(nn.Module):
  """1x1 conv -> coupling -> actnorm on the factored-out part
  (`wolf_glow.py:512-559`)."""

  def __init__(self, in_channels, factor, transform, generator=None,
               device=None, **kw):
    super().__init__()
    self.conv1x1 = Conv1x1Flow(in_channels, generator, device)
    self.coupling = NICE2d(in_channels, factor=factor, transform=transform,
                           split_type="continuous", order="up",
                           generator=generator, device=device, **kw)
    out_channels = in_channels // factor
    self.z1_channels = in_channels - out_channels
    self.actnorm = ActNorm2dFlow(out_channels, generator, device)

  def forward(self, x, h=None, reverse: bool = False):
    ld_total = x.new_zeros(x.shape[0])
    if not reverse:
      for m in (self.conv1x1, self.coupling):
        x, ld = m(x, h=h)
        ld_total = ld_total + ld
      x1, x2 = split2d(x, self.z1_channels)
      x2, ld = self.actnorm(x2)
      return unsplit2d([x1, x2]), ld_total + ld
    x1, x2 = split2d(x, self.z1_channels)
    x2, ld = self.actnorm(x2, reverse=True)
    x = unsplit2d([x1, x2])
    ld_total = ld_total + ld
    for m in (self.coupling, self.conv1x1):
      x, ld = m(x, h=h, reverse=True)
      ld_total = ld_total + ld
    return x, ld_total


class _External(nn.Module):

  def __init__(self, steps):
    super().__init__()
    self.steps = nn.ModuleList(steps)


class _Internal(nn.Module):

  def __init__(self, layers, priors, out_channels):
    super().__init__()
    self.layers = nn.ModuleList(nn.ModuleList(s) for s in layers)
    self.priors = nn.ModuleList(priors)
    self.out_channels = out_channels


class MultiScaleFlow(nn.Module):
  """The wolf multi-scale architecture (`wolf_glow.py:562-705`): the first
  and last levels are runs of steps, each level between them runs its
  layers of steps with a `MultiScalePrior` after each that factors out part
  of the channels; a squeeze between levels (and of a local h). Subclasses
  give the step (`make_step`)."""

  def __init__(self, levels, num_steps, in_channels, factors,
               hidden_channels, h_channels=0, transform="affine",
               prior_transform="affine", alpha=1.0, h_type=None,
               activation="relu", normalize=None, num_groups=None,
               generator=None, device=None, **step_kw):
    super().__init__()
    assert levels > 1 and levels == len(num_steps)
    factors = [0] + list(factors) + [0]
    assert levels == len(factors)
    self.levels = levels
    self.h_channels = h_channels
    self.squeeze_h = h_type is not None and h_type.startswith("local")
    in_ch, h_ch = in_channels, h_channels
    blocks = []
    for level in range(levels):
      ng = num_groups[level] if normalize == "group_norm" else None
      common = dict(hidden_channels=hidden_channels[level],
                    h_channels=h_ch, transform=transform, alpha=alpha,
                    h_type=h_type, activation=activation,
                    normalize=normalize, num_groups=ng, generator=generator,
                    device=device)
      if level > 0:
        in_ch *= 4
        if self.squeeze_h:
          h_ch *= 4
          common["h_channels"] = h_ch
      if level in (0, levels - 1):
        blocks.append(_External([
            self.make_step(in_ch, **step_kw, **common)
            for _ in range(num_steps[level])]))
        continue
      channel_step = in_ch // factors[level]
      cc, ff = in_ch, factors[level]
      layers, priors = [], []
      for ns in num_steps[level]:
        layers.append([self.make_step(cc, **step_kw, **common)
                       for _ in range(ns)])
        prior_kw = dict(common, transform=prior_transform)
        priors.append(MultiScalePrior(cc, ff, **prior_kw))
        cc -= channel_step
        ff -= 1
      blocks.append(_Internal(layers, priors, cc))
      in_ch = cc
    self.blocks = nn.ModuleList(blocks)

  def make_step(self, in_channels, **kw):
    raise NotImplementedError

  def _run_block(self, i, x, h, reverse):
    block = self.blocks[i]
    ld_total = x.new_zeros(x.shape[0])
    if isinstance(block, _External):
      x, ld = run_flows(list(block.steps), x, h, reverse)
      return x, ld
    if not reverse:
      outputs = []
      for layer, prior in zip(block.layers, block.priors):
        x, ld = run_flows(list(layer) + [prior], x, h, False)
        ld_total = ld_total + ld
        x, x2 = split2d(x, prior.z1_channels)
        outputs.append(x2)
      outputs.append(x)
      return unsplit2d(outputs[::-1]), ld_total
    outputs = []
    for prior in block.priors:
      x, x2 = split2d(x, prior.z1_channels)
      outputs.append(x2)
    for layer, prior in zip(reversed(block.layers), reversed(block.priors)):
      x = unsplit2d([x, outputs.pop()])
      x, ld = run_flows(list(layer) + [prior], x, h, True)
      ld_total = ld_total + ld
    return x, ld_total

  def _split_out(self, i):
    return self.blocks[i].out_channels

  def forward(self, x, h=None, reverse: bool = False):
    ld_total = x.new_zeros(x.shape[0])
    if not reverse:
      outputs = []
      for i in range(self.levels):
        x, ld = self._run_block(i, x, h, False)
        ld_total = ld_total + ld
        if i < self.levels - 1:
          if i > 0:
            x, x2 = split2d(x, self._split_out(i))
            outputs.append(x2)
          x = squeeze2d(x, 2)
          if self.squeeze_h and h is not None:
            h = squeeze2d(h, 2)
      x = unsqueeze2d(x, 2)
      for _ in range(self.levels - 2):
        x = unsqueeze2d(unsplit2d([x, outputs.pop()]), 2)
      return x, ld_total
    outputs, hs = [], [h]
    for i in range(self.levels - 1):
      if i > 0:
        x, x2 = split2d(x, self._split_out(i))
        outputs.append(x2)
      x = squeeze2d(x, 2)
      if self.squeeze_h and h is not None:
        h = squeeze2d(h, 2)
      hs.append(h)
    for j, i in enumerate(reversed(range(self.levels))):
      if j > 0:
        x = unsqueeze2d(x, 2)
        h = hs[i]
        if j < self.levels - 1:
          x = unsplit2d([x, outputs.pop()])
      x, ld = self._run_block(i, x, h, True)
      ld_total = ld_total + ld
    return x, ld_total

  @classmethod
  def from_params(cls, params, generator=None, device=None):
    return cls(**params, generator=generator, device=device)


@register_flow("glow")
class Glow(MultiScaleFlow):
  """Glow over the multi-scale architecture (`wolf_glow.py:562-705`)."""

  def make_step(self, in_channels, **kw):
    return GlowStep(in_channels, **kw)
