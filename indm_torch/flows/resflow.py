"""Residual flow (invertible ResNets), PyTorch, NCHW: the inverse pass.

Counterpart of `indm_tpu/flows/resflow.py` for what sampling runs: the sin
activation, the squeeze with the torch channel order (out channel =
c*4 + dy*2 + dx), the 3-1-3 Lipschitz net inside each iResBlock, the
fixed-point inverse of `IResBlock`, and `ResidualFlow.bwdpass`. The JAX
package scans over stacked block parameters; here each block is its own
module and the stack is a loop. Module names follow the reference torch
INDM: `transforms.{scale}.chain.{block}.nnet.{layer}`.

The log-det estimator and the forward pass with log-det belong to training
and are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from indm_torch.flows import lipschitz as lip


def sin_act(x):
  """sin(2*pi*x)/(2*pi): 1-Lipschitz."""
  return torch.sin(2.0 * math.pi * x) / math.pi * 0.5


class SinAct(nn.Module):

  def forward(self, x):
    return sin_act(x)


def squeeze(x, factor: int = 2):
  b, c, h, w = x.shape
  x = x.reshape(b, c, h // factor, factor, w // factor, factor)
  x = x.permute(0, 1, 3, 5, 2, 4)  # (b, c, dy, dx, h2, w2)
  return x.reshape(b, c * factor * factor, h // factor, w // factor)


def unsqueeze(x, factor: int = 2):
  b, c4, h, w = x.shape
  c = c4 // (factor * factor)
  x = x.reshape(b, c, factor, factor, h, w)
  x = x.permute(0, 1, 4, 2, 5, 3)  # (b, c, h, dy, w, dx)
  return x.reshape(b, c, h * factor, w * factor)


# INDM's residual flow (`indm_tpu/flows/flow_model.py:72-80`): 3-1-3 convs,
# Lipschitz coefficient 0.98, the fixed-point inverse's tolerances and cap.
KERNELS = (3, 1, 3)
COEFF = 0.98
INVERSE_ATOL = INVERSE_RTOL = 1e-5
INVERSE_MAX_ITER = 1000


class SqueezeLayer(nn.Module):

  def inverse(self, y, h=None):
    return unsqueeze(y, 2)


class IResBlock(nn.Module):
  """y = x + g(x), g a Lipschitz conv net (`nnet`) with the sin
  activation. With `preact` the net starts with the activation, as in the
  reference's nn.Sequential, so the convs sit at odd indices."""

  def __init__(self, in_ch, idim, cond_dim=None, preact=False,
               generator=None, device=None):
    super().__init__()
    n = len(KERNELS)
    dims = [in_ch] + [idim] * (n - 1) + [in_ch]
    layers = [SinAct()] if preact else []
    for i, k in enumerate(KERNELS):
      cd = cond_dim if (cond_dim is not None and 0 < i < n - 1) else None
      layers.append(lip.LopConv2d(dims[i], dims[i + 1], k, COEFF,
                                  cond_dim=cd, generator=generator,
                                  device=device))
      if i < n - 1:
        layers.append(SinAct())
    self.nnet = nn.ModuleList(layers)

  def g(self, x, h=None):
    for layer in self.nnet:
      x = layer(x, h) if isinstance(layer, lip.LopConv2d) else layer(x)
    return x

  def inverse(self, y, h=None):
    """Fixed point x <- y - g(x) until every element moves by less than its
    tolerance, at most `INVERSE_MAX_ITER` more steps. Returns (x, steps).
    The convergence test reads one flag to the host per step."""
    tol = INVERSE_ATOL + y.abs() * INVERSE_RTOL
    x_prev, x = y, y - self.g(y, h)
    steps = 0
    while (steps <= INVERSE_MAX_ITER
           and bool(((x - x_prev) ** 2 / tol >= 1.0).any())):
      x_prev, x = x, y - self.g(x, h)
      steps += 1
    return x, steps


class StackediResBlocks(nn.Module):
  """One scale: its blocks, then the squeeze when a coarser scale follows."""

  def __init__(self, chain: Sequence[nn.Module]):
    super().__init__()
    self.chain = nn.ModuleList(chain)


def build_stacked_iresblocks(in_ch, idim, n_blocks, squeeze_out, cond_dim,
                             first_resblock, generator=None, device=None):
  """Every block pre-activated but the flow's very first."""
  chain = [IResBlock(in_ch, idim, cond_dim=cond_dim,
                     preact=not (first_resblock and i == 0),
                     generator=generator, device=device)
           for i in range(n_blocks)]
  if squeeze_out:
    chain.append(SqueezeLayer())
  return StackediResBlocks(chain)


class ResidualFlow(nn.Module):
  """Multi-scale residual flow with factor_out=False (the INDM setting)."""

  def __init__(self, image_hw, in_ch, n_blocks=(16, 16),
               intermediate_dim=512, activation_fn="sin",
               cond_dim: Optional[int] = None, generator=None, device=None):
    super().__init__()
    if activation_fn != "sin":
      raise NotImplementedError(f"flow.act_fn={activation_fn!r} is not "
                                "ported yet")
    n_scale_max, hw = 0, image_hw
    while hw >= 4:
      n_scale_max += 1
      hw //= 2
    self.n_scale = min(len(n_blocks), n_scale_max)
    assert self.n_scale > 0
    transforms = []
    c = in_ch
    for i in range(self.n_scale):
      transforms.append(build_stacked_iresblocks(
          c, intermediate_dim, n_blocks[i], i < self.n_scale - 1, cond_dim,
          i == 0, generator=generator, device=device))
      c *= 4
    self.transforms = nn.ModuleList(transforms)
    # fixed-point steps of each block in the last bwdpass, in run order
    self.last_inverse_steps = []

  def inverse(self, z, h=None):
    steps = []
    for t in reversed(self.transforms):
      for layer in reversed(t.chain):
        if isinstance(layer, IResBlock):
          z, n = layer.inverse(z, h)
          steps.append(n)
        else:
          z = layer.inverse(z, h)
    self.last_inverse_steps = steps
    return z

  def bwdpass(self, z, h=None):
    """Image-layout latent -> image."""
    for _ in range(self.n_scale - 1):
      z = squeeze(z, 2)
    with torch.no_grad():
      return self.inverse(z, h), None
