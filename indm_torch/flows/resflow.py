"""Residual flow (invertible ResNets), PyTorch, NCHW.

Counterpart of `indm_tpu/flows/resflow.py`: the sin activation, the squeeze
with the torch channel order (out channel = c*4 + dy*2 + dx), the 3-1-3
Lipschitz net inside each iResBlock, the fixed-point inverse of `IResBlock`
and `ResidualFlow.bwdpass` (sampling), and the training forward with the
unbiased log-det estimator, `ResidualFlow.fwdpass`. The JAX package scans
over stacked block parameters; here each block is its own module and the
stack is a loop. Module names follow the reference torch INDM:
`transforms.{scale}.chain.{block}.nnet.{layer}`.

The training estimator (`indm_tpu/flows/resflow.py:602-683` under
`flow.logdet_pallas`): the stop-gradient Neumann series
u = vareps + sum_k (-1)^k coeff(k) (J^T)^k vareps runs as the Hopper kernel
(`indm_torch.ops.neumann`), then ONE differentiable VJP gives
logdet = <J^T u, vareps>, whose gradient (second order included) autograd
takes. Each block keeps only its input, h, u and vareps for the backward
and recomputes g and the VJP there: the counterpart of the JAX package's
rematerialised scan body that saves `neumann_u`.

The evaluation estimator (`resflow.py:622, 736-755`, `train=False`): the
basic series sum_k (-1)^(k+1) / k coeff(k) <(J^T)^k vareps, vareps> over
n + 20 terms, with the coefficients of `poisson_rcdf_table(2, 20)`, each
term one VJP of g through autograd, nothing differentiable out
(`IResBlock.eval_forward`). The JAX package reaches no kernel there, and
neither does the port; its fixed unroll (`flow.logdet_unroll`) leaves this
estimator alone, as in the JAX package.

With INDM_FUSED_CHAIN=1 in the environment (the JAX package's switch,
`resflow.py:582-589`), a block whose net the fully fused chain takes
(`IResBlock.fused_ok`) runs the chain through
`indm_torch.ops.neumann.fused_neumann_chain` instead, which makes the
activation derivatives from the block input in the same call; the others
keep `chain_mats` and the chain kernel, as in the JAX package.

With `fused_block` (`flow.fused_block`; `indm_tpu/flows/resflow.py:633-662`)
a block whose net the fused kernels take (`IResBlock.fused_ok`) runs as
`indm_torch.ops.fused_block.FusedBlockFn` instead: one kernel for the
forward, the chain and J^T u, one for the analytic backward. The blocks of
a scanned stack (a scale with more than one pre-activated block) run
together through `indm_torch.ops.fused_stack.FusedStackFn`, one kernel per
direction for the whole stack, as the JAX package's
`ScannedIResBlocks._fused_stack` does (`resflow.py:901-937`), unless the
environment sets INDM_FUSED_STACK=0; then each block takes the fused pair.

The precision switches (`resflow.py:315-330, 570-572, 653-654, 930-931`):
`compute_dtype=torch.bfloat16` (`flow.logdet_bf16` or
`flow.mixed_precision`) runs the chain (kernel 7 on `chain_mats` in
bfloat16, or kernel 8), the fused pair and the fused stack in their
bfloat16 mode. `mixed_precision` (`flow.mixed_precision`) also runs the
plain Lipschitz net (`IResBlock.g`: the chain route's one differentiable
VJP, the fixed-point inverse of sampling) in bfloat16 with the weights
normalised in float32, and returns its output in float32.

`unroll_terms` (`flow.logdet_unroll`, 0 for none): the JAX package's fixed
unroll of that many terms, which every kernel route honours by clipping the
draw to n <= unroll_terms - 2 (`kernel_n`; `resflow.py:643-644, 670-674,
917-919`); the coefficients past n + 2 are 0, so the values are those of
the fixed unroll.
"""

from __future__ import annotations

import math
import os
from itertools import groupby
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from indm_torch.flows import lipschitz as lip
from indm_torch.ops import fused_block as fused_lib
from indm_torch.ops import fused_stack as stack_lib
from indm_torch.ops import neumann


# 2 pi and pi in bfloat16: JAX rounds a Python scalar to a bfloat16 array's
# type before the product (both are exact in bfloat16, so a float32 product
# of a bfloat16 value with them, rounded, is JAX's bfloat16 product)
TWO_PI_BF16 = 6.28125
PI_BF16 = 3.140625


def sin_act(x):
  """sin(2*pi*x)/(2*pi): 1-Lipschitz. A bfloat16 x takes 2 pi and pi in
  bfloat16 and rounds each step, as the JAX package's `sin_act` does."""
  if x.dtype == torch.bfloat16:
    return torch.sin(x * TWO_PI_BF16) / PI_BF16 * 0.5
  return torch.sin(2.0 * math.pi * x) / math.pi * 0.5


def dact(a):
  """sigma'(a) = cos(2*pi*a) as `LipschitzNNet.chain_mats` takes it: in a's
  type (2 pi in bfloat16 for a bfloat16 a)."""
  if a.dtype == torch.bfloat16:
    return torch.cos(a * TWO_PI_BF16)
  return torch.cos(2.0 * math.pi * a)


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
# The estimator: n ~ Poisson(2), n + 2 terms in training
# (`indm_tpu/flows/flow_model.py:78-79`: poisson, n_exact_terms 2).
LAMB = 2.0
OFFSET_TRAIN = 2
# the evaluation estimator's exact terms (`resflow.py:622`)
OFFSET_EVAL = 20
_MAX_RCDF = 128


def poisson_rcdf_table(lamb: float, offset: int) -> np.ndarray:
  """rcdf[k] = P(n >= k - offset) for k = 0.._MAX_RCDF, float32 (a copy of
  `indm_tpu/flows/resflow.py:_poisson_rcdf_table`)."""
  out = np.ones(_MAX_RCDF + 1, np.float64)
  for k in range(_MAX_RCDF + 1):
    m = k - offset
    if m > 0:
      s = sum(lamb ** i / math.factorial(i) for i in range(m))
      out[k] = max(1.0 - math.exp(-lamb) * s, 1e-12)
  return out.astype(np.float32)


RCDF_TRAIN = poisson_rcdf_table(LAMB, OFFSET_TRAIN)
RCDF_EVAL = poisson_rcdf_table(LAMB, OFFSET_EVAL)


def eval_coeff(k: int) -> float:
  """(-1)^(k+1) / k coeff(k) of the evaluation estimator's term k <= n + 20,
  in float32 as the JAX loop computes it (coeff(k) = 1 / rcdf(k) there)."""
  f = np.float32
  sign = f(1.0) if k % 2 else f(-1.0)
  return float(sign / f(k) * (f(1.0) / RCDF_EVAL[min(k, _MAX_RCDF)]))


def kernel_n(n: int, unroll_terms: int = 0) -> int:
  """The draw n as the kernel routes take it: under `flow.logdet_unroll`
  (unroll_terms > 0) min(n, unroll_terms - OFFSET_TRAIN), so that the
  series stops after unroll_terms terms, as the JAX package clips it
  (`resflow.py:643-644, 670-674, 917-919`); else n."""
  return min(n, unroll_terms - OFFSET_TRAIN) if unroll_terms else n


class SqueezeLayer(nn.Module):

  def forward(self, x):
    return squeeze(x, 2)

  def inverse(self, y, h=None):
    return unsqueeze(y, 2)


class _BlockLogdet(torch.autograd.Function):
  """(y, logdet) = (x + g(x), <J^T u, vareps> per sample) for a fixed u.

  The forward keeps only (x, h, u, vareps); the backward recomputes g and
  the VJP with a graph (`create_graph`) and differentiates both outputs, so
  the log-det's gradient carries its second-order terms. The block's
  parameters are inputs so that their gradients come back here."""

  @staticmethod
  def forward(ctx, block, x, h, u, vareps, *params):
    ctx.block = block
    ctx.save_for_backward(x, h, u, vareps)
    with torch.enable_grad():
      xd = x.detach().requires_grad_(True)
      y, logdet = block.y_logdet(xd, None if h is None else h.detach(), u,
                                 vareps, create_graph=False)
    return y.detach(), logdet.detach()

  @staticmethod
  def backward(ctx, gy, glogdet):
    x, h, u, vareps = ctx.saved_tensors
    block = ctx.block
    params = list(block.parameters())
    want_h = h is not None and ctx.needs_input_grad[2]
    with torch.enable_grad():
      xd = x.detach().requires_grad_(True)
      hd = None if h is None else h.detach().requires_grad_(want_h)
      y, logdet = block.y_logdet(xd, hd, u, vareps, create_graph=True)
      inputs = [xd] + ([hd] if want_h else []) + params
      grads = list(torch.autograd.grad((y, logdet), inputs, (gy, glogdet),
                                       allow_unused=True))
    gx = grads.pop(0)
    gh = grads.pop(0) if want_h else None
    return (None, gx, gh, None, None, *grads)


class IResBlock(nn.Module):
  """y = x + g(x), g a Lipschitz conv net (`nnet`) with the sin
  activation. With `preact` the net starts with the activation, as in the
  reference's nn.Sequential, so the convs sit at odd indices. `fused_block`
  takes the fused kernel pair in training where the net allows it;
  `in_stack` marks a block that the JAX package runs in a scanned stack;
  `compute_dtype` is the kernels' compute type; `mixed_precision`
  runs `g` in bfloat16 (`LipschitzNNet.apply`); `unroll_terms` is
  `flow.logdet_unroll` (`kernel_n`)."""

  def __init__(self, in_ch, idim, cond_dim=None, preact=False,
               generator=None, device=None, fused_block=False,
               in_stack=False, compute_dtype=torch.float32,
               mixed_precision=False, unroll_terms=0):
    super().__init__()
    self.preact = preact
    self.fused_block = fused_block
    self.in_stack = in_stack
    self.compute_dtype = compute_dtype
    self.mixed_precision = mixed_precision
    self.unroll_terms = unroll_terms
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
    dtype = x.dtype
    if self.mixed_precision:
      x = x.to(torch.bfloat16)
    for layer in self.nnet:
      x = layer(x, h) if isinstance(layer, lip.LopConv2d) else layer(x)
    return x.to(dtype)

  def chain_mats(self, x, h=None, dtype=torch.float32):
    """The chain's ingredients (`LipschitzNNet.chain_mats`) in `dtype`: the
    transposed normalised conv weights and the activation-derivative
    diagonals cos(2 pi a) at each activation's input, both in application
    order (outermost W^T first; [d_out, d_mid, d_in if preact]). In
    bfloat16 (`resflow.py:352-401` with dtype=bfloat16) x, the weights and
    every step are bfloat16: each conv's sum rounded and its bias added in
    bfloat16 (`LopConv2d.forward`), 2 pi a rounded before the cos (`dact`).
    The last conv's output feeds no diagonal and is not computed. Run it
    under no_grad."""
    x = x.to(dtype)
    weights, dacts = [], []
    n_convs = len(self.convs())
    for layer in self.nnet:
      if isinstance(layer, lip.LopConv2d):
        weights.append(layer.normalized_weight().to(dtype))
        if len(weights) == n_convs:
          break
        x = layer(x, h)
      else:
        dacts.append(dact(x))
        x = layer(x)
    weights_t = [neumann.transpose_conv_weight(w).contiguous()
                 for w in reversed(weights)]
    return weights_t, dacts[::-1]

  def y_logdet(self, x, h, u, vareps, create_graph: bool):
    """y = x + g(x) and logdet = <J^T u, vareps>, with J^T u from one VJP
    of g at x (which must require grad)."""
    g = self.g(x, h)
    (jtu,) = torch.autograd.grad(g, x, u, create_graph=create_graph)
    return x + g, (jtu * vareps).flatten(1).sum(1)

  def convs(self) -> List[lip.LopConv2d]:
    return [m for m in self.nnet if isinstance(m, lip.LopConv2d)]

  def fused_ok(self) -> bool:
    """The geometry of the fused kernels (`LipschitzNNet.fused_chain_ok`):
    the port's nets are always sin with 3-1-3 Lop convs, so what remains is
    narrow image channels and a wide intermediate, in_ch < 33 <= width."""
    w0 = self.convs()[0].weight
    return w0.shape[1] < fused_lib.MIN_WIDTH <= w0.shape[0]

  def forward(self, x, h, vareps, n: int, fused_chain: bool = False):
    """Training forward: (y, logdet) with the unbiased estimator of
    log|det(I + J_g)| for the noise (vareps, n); n is the host's
    Poisson(2) draw, so the chain runs n + 2 terms (`kernel_n`).
    `fused_chain` (the INDM_FUSED_CHAIN switch) takes the fully fused chain
    where the net allows it. The chain runs in `compute_dtype` on vareps
    and x cast to it; u = vareps + acc is float32
    (`resflow.py:579-600, 676-682`)."""
    n = kernel_n(n, self.unroll_terms)
    if self.fused_block and self.fused_ok():
      return self._fused_forward(x, h, vareps, n)
    dt = self.compute_dtype
    with torch.no_grad():
      eps = vareps.to(dt)
      if fused_chain and self.fused_ok():
        acc = neumann.fused_neumann_chain(
            x.to(dt).contiguous(), eps,
            *neumann.fused_chain_inputs(self, h, dt), n, OFFSET_TRAIN,
            RCDF_TRAIN, self.preact)
      else:
        weights_t, dacts = self.chain_mats(x, h, dt)
        acc = neumann.neumann_chain(eps, dacts, weights_t, n, OFFSET_TRAIN,
                                    RCDF_TRAIN)
      u = vareps + acc
    return _BlockLogdet.apply(self, x, h, u, vareps, *self.parameters())

  def eval_forward(self, x, h, vareps, n: int):
    """Evaluation forward: (y, logdet) with the basic estimator over
    n + OFFSET_EVAL terms for the noise (vareps, n), each term one VJP of g
    at x (`resflow.py:736-755`). Nothing is differentiable out: y and
    logdet are detached."""
    with torch.enable_grad():
      xd = x.detach().requires_grad_(True)
      g = self.g(xd, None if h is None else h.detach())
    v = vareps
    logdet = torch.zeros(x.shape[0], device=x.device, dtype=x.dtype)
    terms = n + OFFSET_EVAL
    for k in range(1, terms + 1):
      (v,) = torch.autograd.grad(g, xd, v, retain_graph=k < terms)
      logdet = logdet + eval_coeff(k) * (v * vareps).flatten(1).sum(1)
    return (x + g).detach(), logdet

  def stack_ok(self) -> bool:
    """Whether the block runs with the other blocks of its scanned stack
    through the stack kernels (`ScannedIResBlocks._fused_stack`)."""
    return self.in_stack and self.fused_block and self.fused_ok()

  def h_projection(self, h, dtype=torch.float32):
    """hp [B, I], the middle conv's projection of h in `dtype`
    (`LopConv2d.h_projection`), or None."""
    mid = self.convs()[1]
    return None if mid.h_net is None or h is None else mid.h_projection(
        h, dtype)

  def _fused_forward(self, x, h, vareps, n: int):
    """The fused pair. The weight normalisation and the h-projection stay
    in autograd, outside the kernels (`resflow.py:646-652`)."""
    convs = self.convs()
    return fused_lib.FusedBlockFn.apply(
        x, *(c.normalized_weight() for c in convs), *(c.bias for c in convs),
        self.h_projection(h), vareps, n, OFFSET_TRAIN, RCDF_TRAIN,
        self.preact, self.compute_dtype)

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


def fused_stack_forward(blocks: Sequence[IResBlock], x, h, noise):
  """(y, ld_sum) of a run of pre-activated blocks through the stack
  kernels, `noise` one (vareps, n) per block. The stacked weights, biases
  and h-projections are built in autograd from each block's modules
  (`resflow.py:922-929`), so their gradients chain back into every block's
  `LopConv2d`."""
  convs = [b.convs() for b in blocks]
  weights = [torch.stack([c[k].normalized_weight() for c in convs])
             for k in range(3)]
  biases = [torch.stack([c[k].bias for c in convs]) for k in range(3)]
  hps = [b.h_projection(h) for b in blocks]
  hp_all = None if hps[0] is None else torch.stack(hps)
  return stack_lib.FusedStackFn.apply(
      x, *weights, *biases, hp_all, torch.stack([v for v, _ in noise]),
      [kernel_n(n, blocks[0].unroll_terms) for _, n in noise], OFFSET_TRAIN,
      RCDF_TRAIN, blocks[0].preact, blocks[0].compute_dtype)


class StackediResBlocks(nn.Module):
  """One scale: its blocks, then the squeeze when a coarser scale follows."""

  def __init__(self, chain: Sequence[nn.Module]):
    super().__init__()
    self.chain = nn.ModuleList(chain)


def build_stacked_iresblocks(in_ch, idim, n_blocks, squeeze_out, cond_dim,
                             first_resblock, generator=None, device=None,
                             fused_block=False, compute_dtype=torch.float32,
                             mixed_precision=False, unroll_terms=0):
  """Every block pre-activated but the flow's very first. The JAX package
  scans the pre-activated blocks of a scale when there are two or more
  (`indm_tpu/flows/resflow.py:998-1007`): those are `in_stack`."""
  n_special = 1 if first_resblock else 0
  stacked = n_blocks - n_special > 1
  chain = [IResBlock(in_ch, idim, cond_dim=cond_dim,
                     preact=i >= n_special, generator=generator,
                     device=device, fused_block=fused_block,
                     in_stack=stacked and i >= n_special,
                     compute_dtype=compute_dtype,
                     mixed_precision=mixed_precision,
                     unroll_terms=unroll_terms)
           for i in range(n_blocks)]
  if squeeze_out:
    chain.append(SqueezeLayer())
  return StackediResBlocks(chain)


class ResidualFlow(nn.Module):
  """Multi-scale residual flow with factor_out=False (the INDM setting)."""

  def __init__(self, image_hw, in_ch, n_blocks=(16, 16),
               intermediate_dim=512, activation_fn="sin",
               cond_dim: Optional[int] = None, generator=None, device=None,
               fused_block: bool = False, compute_dtype=torch.float32,
               mixed_precision: bool = False, unroll_terms: int = 0):
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
          i == 0, generator=generator, device=device,
          fused_block=fused_block, compute_dtype=compute_dtype,
          mixed_precision=mixed_precision, unroll_terms=unroll_terms))
      c *= 4
    self.transforms = nn.ModuleList(transforms)
    # fixed-point steps of each block in the last bwdpass, in run order
    self.last_inverse_steps = []

  def blocks(self) -> List[IResBlock]:
    return [layer for t in self.transforms for layer in t.chain
            if isinstance(layer, IResBlock)]

  def block_shapes(self, x_shape) -> List[Tuple[int, ...]]:
    """The NCHW input shape of each block, in run order, for an input of
    `x_shape`."""
    b, c, h, w = x_shape
    shapes = []
    for t in self.transforms:
      for layer in t.chain:
        if isinstance(layer, IResBlock):
          shapes.append((b, c, h, w))
        else:
          c, h, w = c * 4, h // 2, w // 2
    return shapes

  def sample_noise(self, x_shape, generator=None, host_rng=None,
                   device=None):
    """The estimator's noise for every block, in run order: vareps ~ N(0, I)
    of the block's input shape (from `generator` on `device`) and
    n ~ Poisson(2) (from the host's numpy `host_rng`)."""
    host_rng = np.random.default_rng() if host_rng is None else host_rng
    return [(torch.randn(shape, generator=generator, device=device),
             int(host_rng.poisson(LAMB)))
            for shape in self.block_shapes(x_shape)]

  def fwdpass(self, x, h=None, noise=None, train: bool = True):
    """Forward, image -> image-layout latent. `noise` is one (vareps, n)
    per block in run order (`sample_noise`). Returns (z, logpx) with
    logpx = -sum of the blocks' log-dets. With `train`, the training
    estimator: each scale's run of `stack_ok` blocks goes through
    `fused_stack_forward` and subtracts their summed log-dets at once, as
    `_fused_stack` does, unless the JAX package's INDM_FUSED_STACK switch
    is "0". INDM_FUSED_CHAIN="1" hands each block the fully fused chain.
    Both are read once, as the JAX step reads them when traced. Without
    `train`, every block runs `eval_forward`, the evaluation estimator."""
    use_stack = train and os.environ.get("INDM_FUSED_STACK", "1") != "0"
    fused_chain = os.environ.get("INDM_FUSED_CHAIN", "0") == "1"
    logpx = torch.zeros(x.shape[0], device=x.device)
    noise = iter(noise)
    def stacked(layer):
      return use_stack and isinstance(layer, IResBlock) and layer.stack_ok()

    for t in self.transforms:
      for in_stack, run in groupby(t.chain, stacked):
        run = list(run)
        if in_stack:
          x, ld_sum = fused_stack_forward(run, x, h,
                                          [next(noise) for _ in run])
          logpx = logpx - ld_sum
        else:
          for layer in run:
            if isinstance(layer, IResBlock):
              vareps, n = next(noise)
              x, logdet = (layer(x, h, vareps, n, fused_chain) if train
                           else layer.eval_forward(x, h, vareps, n))
              logpx = logpx - logdet
            else:
              x = layer(x)
    for _ in range(self.n_scale - 1):
      x = unsqueeze(x, 2)
    return x, logpx

  def fwdpass_plain(self, x, h=None):
    """Forward without the log-det (`fwdpass(eval_logdet=False)` in the
    JAX package): each iResBlock x + g(x, h), nothing drawn."""
    for t in self.transforms:
      for layer in t.chain:
        x = x + layer.g(x, h) if isinstance(layer, IResBlock) else layer(x)
    for _ in range(self.n_scale - 1):
      x = unsqueeze(x, 2)
    return x

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
