"""The wolf presets' MaCow generator: masked convolutional flows (PyTorch,
NCHW).

Counterpart of `indm_tpu/flows/wolf_macow.py:30-373`: `ShiftedConv2d`,
`MCFBlock`, `MaskedConvFlow` with its autoregressive inverse over rows
(orders A and B) and columns (C and D), `MaCowUnit`, `MaCowStep` and
`MaCow` on the multi-scale architecture of `indm_torch.flows.wolf_glow`.

The presets build the generator inverted, so encoding (the training
direction) runs the autoregressive inverse: H or W dependent evaluations of
the masked net per flow. The JAX package writes each solved row into a
padded buffer inside a `fori_loop`, whose backward keeps each step's
window and activations. Here the solved rows are kept as a list and each
window is the concatenation of the last kh of them, so autograd keeps what
that scan keeps (one window and one hidden activation a row) and nothing
of a whole buffer per step. The weight normalisation runs once per flow,
outside the loop.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from indm_torch.flows.wolf import _ACTS
from indm_torch.flows.wolf_glow import (TRANSFORMS, ActNorm2dFlow,
                                        Conv1x1Flow, Conv2dWeightNorm,
                                        MultiScaleFlow, NICE2d, _conv_param,
                                        make_cond_net, register_flow,
                                        run_flows)

_MACOW_TRANSFORMS = ("affine", "additive")


class ShiftedConv2d(nn.Module):
  """The causally shifted conv (`wolf_macow.py:30-62`): order A sees the
  rows strictly above, B strictly below, C the columns strictly left, D
  strictly right. No bias."""

  def __init__(self, in_ch, features, kernel_size, order="A",
               generator=None, device=None):
    super().__init__()
    kh, kw = kernel_size
    self.order = order
    self.kernel_size = (kh, kw)
    self.weight = _conv_param(features, in_ch, kh, kw, generator, device)

  def shift(self, x):
    """x padded and cut so that a VALID conv sees only the causal side."""
    kh, kw = self.kernel_size
    if self.order == "A":
      return F.pad(x, ((kw - 1) // 2, (kw - 1) // 2, kh, 0))[:, :, :-1]
    if self.order == "B":
      return F.pad(x, ((kw - 1) // 2, (kw - 1) // 2, 0, kh))[:, :, 1:]
    if self.order == "C":
      return F.pad(x, (kw, 0, (kh - 1) // 2, (kh - 1) // 2))[:, :, :, :-1]
    if self.order == "D":
      return F.pad(x, (0, kw, (kh - 1) // 2, (kh - 1) // 2))[:, :, :, 1:]
    raise ValueError(self.order)

  def forward(self, x, shifted: bool = True):
    return F.conv2d(self.shift(x) if shifted else x, self.weight)


class MCFBlock(nn.Module):
  """shifted conv -> (+ h) -> act -> weight-norm 1x1, zero at init
  (`wolf_macow.py:65-87`)."""

  def __init__(self, in_ch, out_channels, kernel_size, hidden_channels,
               order, activation="relu", generator=None, device=None):
    super().__init__()
    self.act = _ACTS[activation]
    self.shift_conv = ShiftedConv2d(in_ch, hidden_channels, kernel_size,
                                    order, generator, device)
    self.conv1x1 = Conv2dWeightNorm(hidden_channels, out_channels, (1, 1),
                                    init_scale=0.0, generator=generator,
                                    device=device)

  def forward(self, x, h=None, shifted: bool = True):
    c = self.shift_conv(x, shifted)
    if h is not None:
      c = c + h
    return self.conv1x1(self.act(c))


class MaskedConvFlow(nn.Module):
  """The autoregressive masked-conv flow (`wolf_macow.py:90-238`)."""

  def __init__(self, in_channels, kernel_size, hidden_channels=None,
               h_channels=0, h_type=None, activation="relu", order="A",
               transform="affine", alpha=1.0, generator=None, device=None):
    super().__init__()
    if transform not in _MACOW_TRANSFORMS:
      raise KeyError(f"MaCow takes the transforms {_MACOW_TRANSFORMS}, got "
                     f"{transform!r}, as the JAX package")
    hidden = hidden_channels
    if hidden is None:
      hidden = (4 * in_channels if in_channels <= 96
                else min(2 * in_channels, 512))
    self.order = order
    self.kernel_size = tuple(kernel_size)
    self.alpha = alpha
    self.tfn, mult = TRANSFORMS[transform]
    self.net = MCFBlock(in_channels, in_channels * mult, kernel_size, hidden,
                        order, activation, generator, device)
    self.h_net = make_cond_net(h_type, h_channels, hidden, generator, device)

  def forward(self, x, h=None, reverse: bool = False):
    hc = self.h_net(h) if self.h_net is not None else None
    if not reverse:
      return self.tfn(self.net(x, hc), x, False, self.alpha)
    out = self.invert(x, hc)
    _, ld = self.tfn(self.net(out, hc), out, False, self.alpha)
    return out, -ld

  def invert(self, z, hc):
    """The autoregressive inverse: rows top down (A) or bottom up (B),
    columns left to right (C) or right to left (D). Columns are solved as
    the rows of the transposed z, hc and kernel."""
    cols = self.order in ("C", "D")
    t = (lambda a: a.transpose(2, 3)) if cols else (lambda a: a)
    kh, kw = self.kernel_size[::-1] if cols else self.kernel_size
    w_in = t(self.net.shift_conv.weight)
    w_out, b_out = self.net.conv1x1.weight(), self.net.conv1x1.conv.bias
    act = self.net.act

    def net(window, h):
      c = F.conv2d(window, w_in)
      if h is not None:
        c = c + h
      return F.conv2d(act(c), w_out, b_out)

    out = self._solve_rows(t(z), None if hc is None else t(hc), net, kh, kw,
                           self.order in ("B", "D"))
    return t(out)

  def _solve_rows(self, z, hc, net, kh, kw, backward: bool):
    """The rows of z [B, C, R, S] one at a time: a row reads the kh solved
    rows before it (after it when `backward`), zero past the edge, padded
    by kw // 2 zeros at the sides (`wolf_macow.py:146-172`)."""
    b, c, rows, s = z.shape
    cw = kw // 2
    solved = [z.new_zeros(b, c, 1, s + 2 * cw)] * kh
    for i in range(rows):
      r = rows - 1 - i if backward else i
      window = torch.cat(solved[:kh] if backward else solved[-kh:], dim=2)
      h_row = hc
      if hc is not None and not (hc.shape[2] == 1 and hc.shape[3] == 1):
        h_row = hc[:, :, r:r + 1]
      new_row, _ = self.tfn(net(window, h_row), z[:, :, r:r + 1], True,
                            self.alpha)
      new_row = F.pad(new_row, (cw, cw))
      if backward:
        solved.insert(0, new_row)
      else:
        solved.append(new_row)
    out = torch.cat(solved[:rows] if backward else solved[kh:], dim=2)
    return out[:, :, :, cw:cw + s]


class MaCowUnit(nn.Module):
  """MCF(A) MCF(B) actnorm MCF(C) MCF(D) actnorm (`wolf_macow.py:241-276`)."""

  def __init__(self, in_channels, kernel_size, h_channels=0,
               transform="affine", alpha=1.0, h_type=None,
               activation="relu", generator=None, device=None):
    super().__init__()
    kh, kw = kernel_size
    kw_args = dict(in_channels=in_channels, h_channels=h_channels,
                   transform=transform, alpha=alpha, h_type=h_type,
                   activation=activation, generator=generator, device=device)
    self.conv1 = MaskedConvFlow(kernel_size=(kh, kw), order="A", **kw_args)
    self.conv2 = MaskedConvFlow(kernel_size=(kh, kw), order="B", **kw_args)
    self.actnorm1 = ActNorm2dFlow(in_channels, generator, device)
    self.conv3 = MaskedConvFlow(kernel_size=(kw, kh), order="C", **kw_args)
    self.conv4 = MaskedConvFlow(kernel_size=(kw, kh), order="D", **kw_args)
    self.actnorm2 = ActNorm2dFlow(in_channels, generator, device)

  def forward(self, x, h=None, reverse: bool = False):
    return run_flows([self.conv1, self.conv2, self.actnorm1, self.conv3,
                      self.conv4, self.actnorm2], x, h, reverse)


class MaCowStep(nn.Module):
  """actnorm, 1x1 conv, two units, a coupling pair, actnorm, two units, a
  coupling pair (`wolf_macow.py:279-335`)."""

  def __init__(self, in_channels, kernel_size, hidden_channels=512,
               h_channels=0, transform="affine", alpha=1.0, h_type=None,
               activation="relu", normalize=None, num_groups=None,
               generator=None, device=None):
    super().__init__()
    nkw = dict(in_channels=in_channels, hidden_channels=hidden_channels,
               h_channels=h_channels, transform=transform, alpha=alpha,
               h_type=h_type, activation=activation, normalize=normalize,
               num_groups=num_groups, generator=generator, device=device)
    ukw = dict(in_channels=in_channels, kernel_size=kernel_size,
               h_channels=h_channels, transform=transform, alpha=alpha,
               h_type=h_type, activation=activation, generator=generator,
               device=device)
    self.actnorm1 = ActNorm2dFlow(in_channels, generator, device)
    self.conv1x1 = Conv1x1Flow(in_channels, generator, device)
    self.units1 = nn.ModuleList(MaCowUnit(**ukw) for _ in range(2))
    self.coupling1_up = NICE2d(split_type="continuous", order="up", **nkw)
    self.coupling1_dn = NICE2d(split_type="continuous", order="down", **nkw)
    self.actnorm2 = ActNorm2dFlow(in_channels, generator, device)
    self.units2 = nn.ModuleList(MaCowUnit(**ukw) for _ in range(2))
    self.coupling2_up = NICE2d(split_type="skip", order="up", **nkw)
    self.coupling2_dn = NICE2d(split_type="skip", order="down", **nkw)

  def forward(self, x, h=None, reverse: bool = False):
    mods = ([self.actnorm1, self.conv1x1] + list(self.units1)
            + [self.coupling1_up, self.coupling1_dn, self.actnorm2]
            + list(self.units2) + [self.coupling2_up, self.coupling2_dn])
    return run_flows(mods, x, h, reverse)


@register_flow("macow")
class MaCow(MultiScaleFlow):
  """MaCow over the multi-scale architecture (`wolf_macow.py:338-373`)."""

  def __init__(self, levels, num_steps, in_channels, factors,
               hidden_channels, kernel_size=(2, 3), **kw):
    super().__init__(levels, num_steps, in_channels, factors,
                     hidden_channels, kernel_size=tuple(kernel_size), **kw)

  def make_step(self, in_channels, **kw):
    return MaCowStep(in_channels, **kw)
