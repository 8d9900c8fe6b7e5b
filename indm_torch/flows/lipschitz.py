"""Operator-norm-bounded convolutions of the residual flow (PyTorch, NCHW).

Counterpart of `indm_tpu/flows/lipschitz.py:37-194`: `LopConv2d` scales its
weight by `max(1, ||W||_op / coeff)`. INDM always builds its flow with
`vnorms='ffff'`, domain and codomain inf, whose operator norm is the L1
norm of each output channel's weights; that is the only norm ported.
With `cond_dim` the conv first adds a linear
projection of the conditioning vector h to its input (wolf's
LopCondConv2d). Parameter names follow the reference torch INDM
(`weight` [O, I, k, k], `bias`, `h_net.net.{weight,bias}`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class _HNet(nn.Module):
  """Holds the conditioning projection under the reference's key
  (`h_net.net`)."""

  def __init__(self, cond_dim, in_ch, device=None):
    super().__init__()
    self.net = nn.Linear(cond_dim, in_ch, device=device)


class LopConv2d(nn.Module):

  def __init__(self, in_ch, out_ch, kernel_size, coeff=0.97,
               cond_dim: Optional[int] = None, generator=None, device=None):
    super().__init__()
    self.k = kernel_size
    self.coeff = coeff
    self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size,
                                           kernel_size, device=device))
    self.bias = nn.Parameter(torch.empty(out_ch, device=device))
    self.h_net = (_HNet(cond_dim, in_ch, device) if cond_dim is not None
                  else None)
    if device != "meta":
      bound = 1.0 / math.sqrt(in_ch * kernel_size * kernel_size)
      with torch.no_grad():
        self.weight.uniform_(-bound, bound, generator=generator)
        self.bias.uniform_(-bound, bound, generator=generator)
        if self.h_net is not None:
          hb = 1.0 / math.sqrt(cond_dim)
          self.h_net.net.weight.uniform_(-hb, hb, generator=generator)
          self.h_net.net.bias.uniform_(-hb, hb, generator=generator)

  def normalized_weight(self, param_dtype=None):
    w = self.weight if param_dtype is None else self.weight.to(param_dtype)
    scale = w.abs().sum(dim=(1, 2, 3), keepdim=True)
    return w / torch.clamp(scale / self.coeff, min=1.0)

  def h_projection(self, h, dtype=torch.float32):
    """The projection of h onto the conv's input, [B, in_ch], in `dtype`:
    one linear in float32; in bfloat16 (`lipschitz.py:176-181` under a
    bfloat16 compute type) h @ W and then + b, each rounded."""
    lin = self.h_net.net
    if dtype != torch.bfloat16:
      return F.linear(h.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))
    return F.linear(h.to(dtype), lin.weight.to(dtype)) + lin.bias.to(dtype)

  def forward(self, x, h=None, param_dtype=None):
    """The conv in x's type: a bfloat16 x (the flow's mixed precision,
    `lipschitz.py:175-189`) takes the h-projection and the conv in bfloat16
    with the weight normalised in float32 and then cast, the conv's sum
    and the bias added to it each rounded, as the JAX package's
    `lipschitz_conv_apply(x, w) + b`. `param_dtype` casts the weight
    before its normalisation (parameters cast to bfloat16 as a whole,
    `resflow.py:688-690`)."""
    dt = x.dtype
    if self.h_net is not None:
      if h is None:
        raise ValueError("a conditioned LopConv2d needs h")
      x = x + self.h_projection(h, dt)[:, :, None, None]
    w = self.normalized_weight(param_dtype).to(dt)
    b = self.bias.to(dt)
    if dt != torch.bfloat16:
      return F.conv2d(x, w, b, padding=self.k // 2)
    return F.conv2d(x, w, padding=self.k // 2) + b[:, None, None]
