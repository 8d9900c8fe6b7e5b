"""The fused iResBlock kernel pair: the training forward of one block with
its log-det estimator, and the complete backward of (y, logdet), second-
order terms included. Hopper kernels and their plain versions.

Counterpart of `indm_tpu/ops/fused_block.py`. `fused_block_fwd` and
`fused_block_bwd` are the wrappers: on a CUDA tensor they launch the
hand-written kernels of `indm_torch/csrc/fused_block.cu` (which replace the
TPU kernels `fused_block_fwd_pallas` and `fused_block_bwd_pallas`) or
raise; on a CPU tensor they compute `fused_block_fwd_plain` and
`fused_block_bwd_plain`. `FusedBlockFn` is the custom VJP around them
(`fused_block_apply`). The kernels' design and their bound are in the
source's note; the math is in `fused_block_bwd_plain`.

Layout is NCHW; the weights are the block's Lipschitz-NORMALISED OIHW conv
weights, w0 [I, C, 3, 3], w1 [I, I, 1, 1], w2 [C, I, 3, 3], so their
gradients chain through `LopConv2d.normalized_weight` in autograd, as the
JAX package leaves the normalisation to XLA. hp [B, I] is the projection of
the conditioning vector onto the middle conv's input (or None). n is the
host's Russian-roulette draw: the chain runs n + offset terms with the
coefficients of `neumann.chain_coeffs`.

`fwd_launches` and `bwd_launches` count the wrapper calls that launched
each kernel (a call is a sequence of CUDA launches on one stream).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
import torch.nn.functional as F

from indm_torch.ops import lipnet_gemm, neumann

CHANNELS = (3, 12)
MIN_WIDTH = 33        # the routing's condition: narrow C < 33 <= width
MAX_PADDED = 6144     # C * (H + 2) * (W + 2): the backward's shared tiles
# sigma'' = -(2 pi)^2 sigma for sigma(z) = sin(2 pi z) / (2 pi), in float32
# as the TPU kernel takes it
SIG2 = float(np.float32((2.0 * np.pi) ** 2))

fwd_launches = 0
bwd_launches = 0

_fns = {}


def reset_launches():
  global fwd_launches, bwd_launches
  fwd_launches = bwd_launches = 0


def _act(z):
  """(sigma(z), sigma'(z)) = (sin(2 pi z) / (2 pi), cos(2 pi z))."""
  return (torch.sin(2.0 * math.pi * z) / math.pi * 0.5,
          torch.cos(2.0 * math.pi * z))


def _forward_layers(x, w0, w1, b0, b1, hp, preact):
  """(s0, d0, sin1, s1, d1, s2, d2) of the block's net at x."""
  s0, d0 = _act(x) if preact else (x, None)
  sin1, d1 = _act(F.conv2d(s0, w0, b0, padding=1))
  s1 = sin1 if hp is None else sin1 + hp[:, :, None, None]
  s2, d2 = _act(F.conv2d(s1, w1, b1))
  return s0, d0, sin1, s1, d1, s2, d2


def _transposed(w0, w1, w2):
  """The transposed (VJP) convs of w2, w1, w0: W2^T [I, C, 3, 3],
  W1^T [I, I, 1, 1], W0^T [C, I, 3, 3]."""
  return [neumann.transpose_conv_weight(w).contiguous() for w in (w2, w1, w0)]


def fused_block_fwd_plain(x, w0, w1, w2, b0, b1, b2, hp, vareps, n: int,
                          offset: int, table, preact: bool):
  """(y, logdet, u) with plain tensor ops: y = x + g(x),
  u = vareps + sum_k (-1)^k coeff(k) (J^T)^k vareps,
  logdet = <J^T u, vareps> per sample."""
  s0, d0, _, _, d1, s2, d2 = _forward_layers(x, w0, w1, b0, b1, hp, preact)
  y = x + F.conv2d(s2, w2, b2, padding=1)
  w2t, w1t, w0t = _transposed(w0, w1, w2)
  u = vareps + neumann.neumann_chain_plain(
      vareps, [d2, d1] + ([] if d0 is None else [d0]), [w2t, w1t, w0t],
      int(n), int(offset), table)
  jtu = F.conv2d(F.conv2d(F.conv2d(u, w2t, padding=1) * d2, w1t) * d1, w0t,
                 padding=1)
  jtu = jtu if d0 is None else jtu * d0
  logdet = (jtu * vareps).flatten(1).sum(1)
  return y, logdet, u


def fused_block_bwd_plain(x, vareps, u, ybar, lbar, w0, w1, w2, b0, b1, hp,
                          preact: bool):
  """The gradients of sum(ybar * y) + sum(lbar * logdet) with respect to
  (x, w0, w1, w2, b0, b1, b2, hp), u held constant: the analytic formulas
  of `fused_block.py:43-63` in plain tensor ops (no autograd graph).
  hbar is None without hp."""
  s0, d0, sin1, s1, d1, s2, d2 = _forward_layers(x, w0, w1, b0, b1, hp,
                                                 preact)
  w2t, w1t, w0t = _transposed(w0, w1, w2)
  wgrad = torch.nn.grad.conv2d_weight
  # the tangent J vareps, layer by layer
  t0 = vareps if d0 is None else d0 * vareps
  a1 = F.conv2d(t0, w0, padding=1)
  t1 = d1 * a1
  a2 = F.conv2d(t1, w1)
  t2 = d2 * a2
  v = lbar[:, None, None, None] * u
  # layer 2
  w2g = (wgrad(s2, w2.shape, ybar, padding=1)
         + wgrad(t2, w2.shape, v, padding=1))
  b2g = ybar.sum((0, 2, 3))
  s2b = F.conv2d(ybar, w2t, padding=1)
  t2b = F.conv2d(v, w2t, padding=1)
  z2b = d2 * s2b - SIG2 * s2 * (a2 * t2b)
  a2b = d2 * t2b
  # layer 1
  w1g = (torch.einsum("bohw,bihw->oi", z2b, s1)
         + torch.einsum("bohw,bihw->oi", a2b, t1))[:, :, None, None]
  b1g = z2b.sum((0, 2, 3))
  s1b = F.conv2d(z2b, w1t)
  t1b = F.conv2d(a2b, w1t)
  hbar = None if hp is None else s1b.sum((2, 3))
  z1b = d1 * s1b - SIG2 * sin1 * (a1 * t1b)
  a1b = d1 * t1b
  # layer 0
  w0g = (wgrad(s0, w0.shape, z1b, padding=1)
         + wgrad(t0, w0.shape, a1b, padding=1))
  b0g = z1b.sum((0, 2, 3))
  s0b = F.conv2d(z1b, w0t, padding=1)
  if d0 is None:
    xbar = ybar + s0b
  else:
    t0b = F.conv2d(a1b, w0t, padding=1)
    xbar = ybar + d0 * s0b - SIG2 * (s0 * vareps * t0b)
  return xbar, w0g, w1g, w2g, b0g, b1g, b2g, hbar


def _kernel(name):
  fn = _fns.get(name)
  if fn is None:
    from indm_torch.ops import build
    fn = getattr(build.load("fused_block.cu"), name)
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "indm_fused_block_fwd":
      fn.argtypes = ([p] * 12 + [ctypes.POINTER(ctypes.c_float), i, i]
                     + [p] * 4 + [ctypes.c_int64] + [i] * 5 + [p])
    else:
      fn.argtypes = [p] * 13 + [i] + [p] * 9 + [ctypes.c_int64] + [i] * 5 + [p]
    fn.restype = ctypes.c_int
    _fns[name] = fn
  return fn


def _check(x, w0, w1, w2, b0, b1, hp, b2=None, narrow=(), lbar=None,
           what="fused_block"):
  """Raise ValueError on any input the kernels do not take."""
  def bad(msg):
    raise ValueError(f"{what}: {msg}")

  if x.dim() != 4:
    bad(f"x must be NCHW, got {tuple(x.shape)}")
  b, c, h, w = x.shape
  idim = w0.shape[0]
  if c not in CHANNELS:
    bad(f"the kernels are built for {CHANNELS} channels, got {c}")
  if idim < MIN_WIDTH or idim % 4 or (h * w) % 4:
    bad(f"the width ({idim}) must be at least {MIN_WIDTH} and, like H*W "
        f"({h * w}), a multiple of 4")
  if c * (h + 2) * (w + 2) > MAX_PADDED:
    bad(f"C*(H+2)*(W+2) = {c * (h + 2) * (w + 2)} exceeds {MAX_PADDED}, "
        "the backward's shared-memory tile")
  if b * idim * max(h * w, idim) >= 2 ** 31:
    bad("the kernels index a wide tensor with 32-bit ints")
  want = [("x", x, (b, c, h, w)), ("w0", w0, (idim, c, 3, 3)),
          ("w1", w1, (idim, idim, 1, 1)), ("w2", w2, (c, idim, 3, 3)),
          ("b0", b0, (idim,)), ("b1", b1, (idim,))]
  if b2 is not None:
    want.append(("b2", b2, (c,)))
  if hp is not None:
    want.append(("hp", hp, (b, idim)))
  if lbar is not None:
    want.append(("lbar", lbar, (b,)))
  want += [(name, t, (b, c, h, w)) for name, t in narrow]
  for name, t, shape in want:
    if tuple(t.shape) != shape:
      bad(f"{name}: expected {shape}, got {tuple(t.shape)}")
    if (t.dtype != torch.float32 or not t.is_contiguous()
        or t.device != x.device or t.data_ptr() % 16):
      bad(f"{name} must be a contiguous, 16-byte aligned float32 tensor on "
          f"{x.device}")


def _device_call(x, fn, *args):
  """fn(*args, stream) on x's card and current stream; raises on a CUDA
  error."""
  with torch.cuda.device(x.device):
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(*args, stream)
  if rc != 0:
    raise RuntimeError(f"{fn.__name__} failed with CUDA error {rc}")


def _ptr(t):
  return None if t is None else t.data_ptr()


def plane_floats(idim):
  """One block's TF32 planes of W1 and W1^T for the forward's `wgmma`
  products (`plane_floats` of `csrc/fused_block_ops.cuh`): 4*I*I8 floats,
  I8 = I rounded up to a multiple of 8."""
  return 4 * idim * lipnet_gemm.padded_k(idim)


def fwd_scratch_floats(b, c, hw, idim, blocks=1):
  """The forward's scratch for `blocks` blocks' weight planes and one
  block's temporaries (`fwd_scratch` of `csrc/fused_block_ops.cuh`):
  kernel 3's with one block."""
  return blocks * plane_floats(idim) + 4 * b * idim * hw + 5 * b * c * hw


def bwd_scratch_floats(b, c, hw, idim):
  """Kernel 4's scratch (`bwd_scratch` of `csrc/fused_block_ops.cuh`)."""
  return (11 * b * idim * hw + 6 * b * c * hw + b * idim * idim
          + 18 * b * idim * c + 2 * b * idim + b * c)


def fused_block_fwd(x, w0, w1, w2, b0, b1, b2, hp, vareps, n: int,
                    offset: int, table, preact: bool):
  """(y, logdet, u) of one block. A CPU tensor takes the plain version; a
  CUDA tensor launches kernel 3 on the current stream (and raises on any
  input it does not take)."""
  global fwd_launches
  if x.device.type == "cpu":
    return fused_block_fwd_plain(x, w0, w1, w2, b0, b1, b2, hp, vareps, n,
                                 offset, table, preact)
  if x.device.type != "cuda":
    raise ValueError(f"fused_block_fwd runs on cpu or cuda, not {x.device}")
  _check(x, w0, w1, w2, b0, b1, hp, b2=b2, narrow=[("vareps", vareps)])
  b, c, h, w = x.shape
  idim = w0.shape[0]
  coeffs = neumann.chain_coeffs(int(n), int(offset), table)
  w2t, w1t, w0t = _transposed(w0, w1, w2)
  y, u = torch.empty_like(x), torch.empty_like(x)
  logdet = torch.empty(b, device=x.device)
  scratch = torch.empty(fwd_scratch_floats(b, c, h * w, idim),
                        device=x.device)
  _device_call(x, _kernel("indm_fused_block_fwd"), x.data_ptr(),
               vareps.data_ptr(), w0.data_ptr(), w1.data_ptr(),
               w2.data_ptr(), w2t.data_ptr(), w1t.data_ptr(), w0t.data_ptr(),
               b0.data_ptr(), b1.data_ptr(), b2.data_ptr(), _ptr(hp),
               coeffs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
               len(coeffs), int(preact), y.data_ptr(), u.data_ptr(),
               logdet.data_ptr(), scratch.data_ptr(), scratch.numel(), b, c,
               h, w, idim)
  fwd_launches += 1
  return y, logdet, u


def fused_block_bwd(x, vareps, u, ybar, lbar, w0, w1, w2, b0, b1, hp,
                    preact: bool):
  """(xbar, w0g, w1g, w2g, b0g, b1g, b2g, hbar) of one block for the
  cotangents (ybar, lbar). A CPU tensor takes the plain version; a CUDA
  tensor launches kernel 4 on the current stream (and raises on any input
  it does not take)."""
  global bwd_launches
  if x.device.type == "cpu":
    return fused_block_bwd_plain(x, vareps, u, ybar, lbar, w0, w1, w2, b0,
                                 b1, hp, preact)
  if x.device.type != "cuda":
    raise ValueError(f"fused_block_bwd runs on cpu or cuda, not {x.device}")
  _check(x, w0, w1, w2, b0, b1, hp, lbar=lbar,
         narrow=[("vareps", vareps), ("u", u), ("ybar", ybar)])
  b, c, h, w = x.shape
  idim = w0.shape[0]
  w2t, w1t, w0t = _transposed(w0, w1, w2)
  xbar = torch.empty_like(x)
  w0g, w1g, w2g = (torch.empty_like(t) for t in (w0, w1, w2))
  b0g, b1g = torch.empty_like(b0), torch.empty_like(b1)
  b2g = torch.empty(c, device=x.device)
  hbar = None if hp is None else torch.empty_like(hp)
  scratch = torch.empty(bwd_scratch_floats(b, c, h * w, idim),
                        device=x.device)
  _device_call(x, _kernel("indm_fused_block_bwd"), x.data_ptr(),
               vareps.data_ptr(), u.data_ptr(), ybar.data_ptr(),
               lbar.data_ptr(), w0.data_ptr(), w1.data_ptr(), w2t.data_ptr(),
               w1t.data_ptr(), w0t.data_ptr(), b0.data_ptr(), b1.data_ptr(),
               _ptr(hp), int(preact),
               xbar.data_ptr(), w0g.data_ptr(), w1g.data_ptr(),
               w2g.data_ptr(), b0g.data_ptr(), b1g.data_ptr(),
               b2g.data_ptr(), _ptr(hbar), scratch.data_ptr(),
               scratch.numel(), b, c, h, w, idim)
  bwd_launches += 1
  return xbar, w0g, w1g, w2g, b0g, b1g, b2g, hbar


class FusedBlockFn(torch.autograd.Function):
  """(y, logdet) of one block through `fused_block_fwd`, with its backward
  through `fused_block_bwd`. Inputs: x, the three normalised weights, the
  three biases, hp (or None), vareps, n, offset, table, preact. It saves
  (x, weights, b0, b1, hp, vareps, u), the residuals of the TPU pair's
  custom VJP (`_fused_fwd`), and recomputes the rest in the backward."""

  @staticmethod
  def forward(ctx, x, w0, w1, w2, b0, b1, b2, hp, vareps, n, offset, table,
              preact):
    y, logdet, u = fused_block_fwd(x, w0, w1, w2, b0, b1, b2, hp, vareps, n,
                                   offset, table, preact)
    ctx.save_for_backward(x, w0, w1, w2, b0, b1, hp, vareps, u)
    ctx.preact = preact
    return y, logdet

  @staticmethod
  def backward(ctx, ybar, lbar):
    x, w0, w1, w2, b0, b1, hp, vareps, u = ctx.saved_tensors
    ybar = torch.zeros_like(x) if ybar is None else ybar.contiguous()
    lbar = (x.new_zeros(x.shape[0]) if lbar is None else lbar.contiguous())
    grads = fused_block_bwd(x, vareps, u, ybar, lbar, w0, w1, w2, b0, b1, hp,
                            ctx.preact)
    return (*grads, None, None, None, None, None)
