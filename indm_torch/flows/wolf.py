"""Wolf VAE-flow pieces that sampling runs (PyTorch): the NICE flow prior
over h and its sampling pass.

Counterpart of `indm_tpu/flows/wolf.py:39-54, 275-465, 551-557`. Module
names follow the reference torch INDM
(`discriminator.prior.flow.steps.{i}.{actnorm,linear,unit}...`), so that
`indm_tpu/flows/convert.py:_prior_step` reads the state_dict. The
Gaussian encoder runs only in training and density evaluation, and is not
ported yet.
"""

from __future__ import annotations

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
    z1, z2 = self._split(z)
    zc, zp = (z1, z2) if self.order == "up" else (z2, z1)
    mu, log_scale = self.net(zc).chunk(2, dim=-1)
    scale = torch.sigmoid(log_scale + 2.0) + 1e-3
    zp = (zp - mu) / (scale + 1e-12) if reverse else scale * zp + mu
    z1, z2 = (zc, zp) if self.order == "up" else (zp, zc)
    return self._unsplit(z1, z2)


class ActNorm1dFlow(nn.Module):

  def __init__(self, in_features, generator=None, device=None):
    super().__init__()
    self.log_scale = nn.Parameter(torch.empty(in_features, device=device))
    self.bias = nn.Parameter(torch.zeros(in_features, device=device))
    if device != "meta":
      with torch.no_grad():
        self.log_scale.normal_(0.0, 0.05, generator=generator)

  def forward(self, x, reverse: bool = False):
    if reverse:
      return (x - self.bias) / (torch.exp(self.log_scale) + 1e-8)
    return x * torch.exp(self.log_scale) + self.bias


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
      return x @ w_inv.T
    return x @ self.weight.T


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
    for m in (reversed(mods) if reverse else mods):
      x = m(x, reverse=reverse)
    return x


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
    for m in (reversed(mods) if reverse else mods):
      x = m(x, reverse=reverse)
    return x


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
    out = epsilon
    for step in reversed(self.steps):
      out = step(out, reverse=True)
    return out


class FlowPrior(nn.Module):

  def __init__(self, num_steps, in_features, hidden_features,
               activation="elu", generator=None, device=None):
    super().__init__()
    self.flow = PriorFlow(num_steps, in_features, hidden_features,
                          activation, generator, device)


class GaussianDiscriminator(nn.Module):
  """The Gaussian 'discriminator' of the wolf preset; sampling needs only
  its flow prior over the `dim`-wide h."""

  def __init__(self, dim, prior_steps, prior_hidden, prior_activation="elu",
               generator=None, device=None):
    super().__init__()
    self.dim = dim
    self.prior = FlowPrior(prior_steps, dim, prior_hidden, prior_activation,
                           generator, device)

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


def make_discriminator(wolf_params, generator=None, device=None):
  d = wolf_params["discriminator"]
  prior = d.get("prior", {})
  if d["type"] != "gaussian" or prior.get("type") != "flow":
    raise NotImplementedError(
        f"only the gaussian discriminator with a flow prior is ported, got "
        f"{d['type']!r} / {prior.get('type')!r}")
  return GaussianDiscriminator(d["dim"], prior["num_steps"],
                               prior["hidden_features"],
                               prior.get("activation", "elu"), generator,
                               device)
