"""Bias-add and scaled leaky ReLU, the StyleGAN2 activation.

Counterpart of `indm_tpu/ops/fused_act.py:17-38`, which has no Pallas
kernel (XLA fuses the chain), so neither has the port: plain tensor ops,
on NCHW tensors (the bias broadcasts over dim 1). No net of either package
calls it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def fused_leaky_relu(x, bias=None, negative_slope: float = 0.2,
                     scale: float = math.sqrt(2.0)):
  """leaky_relu(x + bias) * scale."""
  if bias is not None:
    x = x + bias.reshape((1, -1) + (1,) * (x.dim() - 2))
  return F.leaky_relu(x, negative_slope) * scale


class FusedLeakyReLU:
  """The reference's module form: a zero bias of `channel` values."""

  def __init__(self, channel, negative_slope=0.2, scale=math.sqrt(2.0),
               device=None):
    self.bias = torch.zeros(channel, device=device)
    self.negative_slope = negative_slope
    self.scale = scale

  def __call__(self, x):
    return fused_leaky_relu(x, self.bias, self.negative_slope, self.scale)
