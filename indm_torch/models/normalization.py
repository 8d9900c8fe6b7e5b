"""The normalization zoo of the RefineNet score nets (PyTorch, NCHW).

Counterpart of `indm_tpu/models/normalization.py`: InstanceNorm,
VarianceNorm, InstanceNorm++ and none, and their class-conditional
versions, each scaled and shifted by an embedding of the labels. Parameter
names are the reference's (`alpha`, `gamma`, `beta`, `embed.weight`,
`bn.running_mean`); where the JAX package keeps a gain as its offset from 1
(`param + 1.0`), the port keeps the gain itself, as the reference does,
and `indm_torch.convert` adds the 1.

Statistics are the JAX package's: the biased spatial variance with eps
1e-5; InstanceNorm++'s standardisation of the channel means takes the
variance with ddof=1 (`normalization.py:53-56`); `ConditionalBatchNorm2d`
is flax's `nn.BatchNorm` (momentum 0.99, the biased batch variance
E[x^2] - mean^2, eps 1e-5), with the running statistics in
`bn.running_mean` and `bn.running_var`.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from indm_torch.models import layers

EPS = 1e-5


def _normal_(t, mean, std, generator):
  with torch.no_grad():
    t.normal_(mean, std, generator=generator)
  return t


def _param(c, device, fill=0.0, std=None, generator=None):
  p = nn.Parameter(torch.full((c,), fill, device=device))
  if std is not None and device != "meta":
    _normal_(p, fill, std, generator)
  return p


def instance_norm(x):
  """(x - mean) / sqrt(var + 1e-5) over each (sample, channel)'s pixels,
  the biased variance."""
  mean = x.mean(dim=(2, 3), keepdim=True)
  var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
  return (x - mean) / torch.sqrt(var + EPS)


def standardized_means(x):
  """InstanceNorm++'s channel means [B, C], standardised over the channels
  with the variance at ddof=1."""
  means = x.mean(dim=(2, 3))
  m = means.mean(dim=-1, keepdim=True)
  v = means.var(dim=-1, keepdim=True, unbiased=True)
  return (means - m) / torch.sqrt(v + EPS)


def _bc(v):
  return v[..., None, None] if v.dim() == 2 else v[None, :, None, None]


class InstanceNorm2d(nn.Module):
  """Instance norm without affine parameters."""

  def __init__(self, num_features=None, generator=None, device=None):
    super().__init__()

  def forward(self, x):
    return instance_norm(x)


class VarianceNorm2d(nn.Module):
  """x / sqrt(var + 1e-5) times `alpha` ~ N(1, 0.02), plus `beta` with
  `bias`."""

  def __init__(self, num_features, bias=False, generator=None, device=None):
    super().__init__()
    self.alpha = _param(num_features, device, 1.0, 0.02, generator)
    self.beta = _param(num_features, device) if bias else None

  def forward(self, x):
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    out = x / torch.sqrt(var + EPS) * _bc(self.alpha)
    return out if self.beta is None else out + _bc(self.beta)


class InstanceNorm2dPlus(nn.Module):
  """InstanceNorm++ (`normalization.py:42-61`): the instance norm plus
  `alpha` times the standardised channel means, scaled by `gamma` (both ~
  N(1, 0.02)) and shifted by `beta` with `bias`."""

  def __init__(self, num_features, bias=True, generator=None, device=None):
    super().__init__()
    self.alpha = _param(num_features, device, 1.0, 0.02, generator)
    self.gamma = _param(num_features, device, 1.0, 0.02, generator)
    self.beta = _param(num_features, device) if bias else None

  def forward(self, x):
    h = instance_norm(x) + _bc(standardized_means(x)) * _bc(self.alpha)
    out = _bc(self.gamma) * h
    return out if self.beta is None else out + _bc(self.beta)


class NoneNorm2d(nn.Module):
  """The identity."""

  def __init__(self, num_features=None, generator=None, device=None):
    super().__init__()

  def forward(self, x):
    return x


class BatchNorm2d(nn.Module):
  """flax's `nn.BatchNorm` without scale and bias: with `train` it
  normalises with the batch mean and the biased variance E[x^2] - mean^2
  (clamped at 0) and moves the running statistics by momentum 0.99 toward
  both; without, it uses the running statistics. The buffer names are
  torch's."""

  def __init__(self, num_features, momentum=0.99, device=None):
    super().__init__()
    self.momentum = momentum
    self.register_buffer("running_mean",
                         torch.zeros(num_features, device=device))
    self.register_buffer("running_var",
                         torch.ones(num_features, device=device))
    self.register_buffer("num_batches_tracked",
                         torch.zeros((), dtype=torch.long, device=device))

  def forward(self, x, train: bool = True):
    if train:
      mean = x.mean(dim=(0, 2, 3))
      var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
      with torch.no_grad():
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)
        self.num_batches_tracked += 1
    else:
      mean, var = self.running_mean, self.running_var
    return (x - _bc(mean)) * _bc(torch.rsqrt(var + EPS))


class _Conditional(nn.Module):
  """A class embedding `embed` [num_classes, n * C]."""

  def __init__(self, num_features, num_classes, n, device):
    super().__init__()
    self.num_features = num_features
    self.embed = nn.Embedding(num_classes, n * num_features, device=device)

  def _uniform_gain(self, generator):
    """The reference's init (`normalization.py:66-77`): the gain U[0, 1),
    the shift 0."""
    if self.embed.weight.device.type == "meta":
      return
    with torch.no_grad():
      c = self.num_features
      self.embed.weight.zero_()
      self.embed.weight[:, :c].uniform_(0.0, 1.0, generator=generator)

  def parts(self, y, n):
    return [_bc(e) for e in self.embed(y.long()).chunk(n, dim=-1)]


class ConditionalBatchNorm2d(_Conditional):
  """BatchNorm without affine parameters (flax's, see the module note),
  scaled by the class embedding's gain and shifted by its bias with
  `bias`. With `train` (the default, whatever the module's mode, as the
  JAX module's `train=True`) it normalises with the batch's statistics and
  moves the running ones; without, it uses the running ones."""

  def __init__(self, num_features, num_classes, bias=True, generator=None,
               device=None):
    super().__init__(num_features, num_classes, 2 if bias else 1, device)
    self.bias = bias
    self.bn = BatchNorm2d(num_features, device=device)
    self._uniform_gain(generator)

  def forward(self, x, y, train: bool = True):
    h = self.bn(x, train)
    if self.bias:
      gamma, beta = self.parts(y, 2)
      return gamma * h + beta
    return self.parts(y, 1)[0] * h


class ConditionalInstanceNorm2d(_Conditional):
  def __init__(self, num_features, num_classes, bias=True, generator=None,
               device=None):
    super().__init__(num_features, num_classes, 2 if bias else 1, device)
    self.bias = bias
    self._uniform_gain(generator)

  def forward(self, x, y):
    h = instance_norm(x)
    if self.bias:
      gamma, beta = self.parts(y, 2)
      return gamma * h + beta
    return self.parts(y, 1)[0] * h


class ConditionalVarianceNorm2d(_Conditional):
  """The variance norm scaled by the class embedding ~ N(1, 0.02)."""

  def __init__(self, num_features, num_classes, bias=False, generator=None,
               device=None):
    super().__init__(num_features, num_classes, 1, device)
    if device != "meta":
      _normal_(self.embed.weight, 1.0, 0.02, generator)

  def forward(self, x, y):
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    return self.parts(y, 1)[0] * (x / torch.sqrt(var + EPS))


class ConditionalNoneNorm2d(_Conditional):
  """The class embedding's affine map alone."""

  def __init__(self, num_features, num_classes, bias=True, generator=None,
               device=None):
    super().__init__(num_features, num_classes, 2 if bias else 1, device)
    self.bias = bias
    self._uniform_gain(generator)

  def forward(self, x, y):
    if self.bias:
      gamma, beta = self.parts(y, 2)
      return gamma * x + beta
    return self.parts(y, 1)[0] * x


class ConditionalInstanceNorm2dPlus(_Conditional):
  """Class-conditional InstanceNorm++: the embedding holds gamma, alpha
  (both ~ N(1, 0.02)) and, with `bias`, beta (0)."""

  def __init__(self, num_features, num_classes, bias=True, generator=None,
               device=None):
    n = 3 if bias else 2
    super().__init__(num_features, num_classes, n, device)
    self.bias = bias
    if device != "meta":
      with torch.no_grad():
        self.embed.weight.zero_()
        _normal_(self.embed.weight[:, :2 * num_features], 1.0, 0.02,
                 generator)

  def forward(self, x, y):
    h = instance_norm(x)
    means = _bc(standardized_means(x))
    if self.bias:
      gamma, alpha, beta = self.parts(y, 3)
      return gamma * (h + means * alpha) + beta
    gamma, alpha = self.parts(y, 2)
    return gamma * (h + means * alpha)


def group_norm(num_features, generator=None, device=None):
  """flax's plain `nn.GroupNorm(32, epsilon=1e-6)`: no kernel in either
  package."""
  return layers.GroupNorm(32, num_features, device=device)


CONDITIONAL = {"InstanceNorm++": ConditionalInstanceNorm2dPlus,
               "InstanceNorm": ConditionalInstanceNorm2d,
               "BatchNorm": ConditionalBatchNorm2d,
               "VarianceNorm": ConditionalVarianceNorm2d,
               "NoneNorm": ConditionalNoneNorm2d}
PLAIN = {"InstanceNorm": InstanceNorm2d, "InstanceNorm++": InstanceNorm2dPlus,
         "VarianceNorm": VarianceNorm2d, "NoneNorm": NoneNorm2d,
         "GroupNorm": group_norm}


def get_normalization(config, conditional: bool = False):
  """`normalization.py:178-207`: a constructor norm(num_features,
  generator=None, device=None) for `model.normalization`, the conditional
  table with `model.num_classes` classes (which no config defines: the
  caller sets it, in both packages)."""
  norm = config.model.normalization
  if conditional:
    if norm not in CONDITIONAL:
      raise NotImplementedError(f"{norm} not implemented yet.")
    return functools.partial(CONDITIONAL[norm],
                             num_classes=config.model.num_classes)
  if norm not in PLAIN:
    raise ValueError(f"Unknown normalization: {norm}")
  return PLAIN[norm]
