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

`compute_dtype` selects the kernels' mode: float32, or bfloat16, the
TPU pair's `compute_dtype=bfloat16` (`flow.logdet_bf16` or
`flow.mixed_precision`), whose rounding points the plain versions spell
out. The inputs and outputs are float32 in either mode.

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
# C * (H + 2) * (W + 2): the backward's two padded narrow planes of floats
# in the 227 KB of shared memory a Hopper block may opt in to
# (`fused_ops::kMaxPadded`); CelebA's first flow scale, 12 x 32 x 32, is
# 13 872
MAX_PADDED = 232448 // (2 * 4)
# sigma'' = -(2 pi)^2 sigma for sigma(z) = sin(2 pi z) / (2 pi), in float32
# as the TPU kernel takes it
SIG2 = float(np.float32((2.0 * np.pi) ** 2))

fwd_launches = 0
bwd_launches = 0

_fns = {}


def reset_launches():
  global fwd_launches, bwd_launches
  fwd_launches = bwd_launches = 0


def rounder(compute_dtype):
  """r(t): t rounded to the compute type and held in t's type, the rounding
  of the TPU pair's `.astype(cdt)`; the identity for float32. The plain
  versions hold their values in float32; on float64 inputs they keep every
  rounding point and compute the rest exactly (a reference for the
  kernels on the card, where float32 cuDNN convs may run as FFTs)."""
  if compute_dtype == torch.float32:
    return _exact
  if compute_dtype != torch.bfloat16:
    raise ValueError(f"the fused kernels compute in float32 or bfloat16, "
                     f"not {compute_dtype}")
  return lambda t: t.to(torch.bfloat16).to(t.dtype)


def _exact(t):
  return t


def _act(z, r=_exact):
  """(sigma(z), sigma'(z)) = (sin(2 pi z) / (2 pi), cos(2 pi z)), each
  taken in float32 and rounded by r."""
  return (r(torch.sin(2.0 * math.pi * z) / math.pi * 0.5),
          r(torch.cos(2.0 * math.pi * z)))


def _layer(v, w, b, r):
  """conv(v, w) + b: in float32 one conv with its bias; with a rounding r
  the sum is rounded, then the bias added and the result rounded again
  (`fused_block.py:265-271`)."""
  if r is _exact:
    return F.conv2d(v, w, b, padding=w.shape[-1] // 2)
  return r(r(F.conv2d(v, w, padding=w.shape[-1] // 2)) + b[None, :, None,
                                                             None])


def _forward_layers(x, w0, w1, b0, b1, hp, preact, r=_exact):
  """(s0, d0, sin1, s1, d1, s2, d2) of the block's net at x."""
  s0, d0 = _act(x, r) if preact else (x, None)
  sin1, d1 = _act(_layer(s0, w0, b0, r), r)
  s1 = sin1 if hp is None else r(sin1 + hp[:, :, None, None])
  s2, d2 = _act(_layer(s1, w1, b1, r), r)
  return s0, d0, sin1, s1, d1, s2, d2


def _transposed(w0, w1, w2):
  """The transposed (VJP) convs of w2, w1, w0: W2^T [I, C, 3, 3],
  W1^T [I, I, 1, 1], W0^T [C, I, 3, 3]."""
  return [neumann.transpose_conv_weight(w).contiguous() for w in (w2, w1, w0)]


def _operands(r, x, ws, bs, hp, vareps):
  """The kernels' operands in the compute type, as the TPU pair casts them
  outside its body (`fused_block.py:302-316, 497-505`): x, the weights,
  the biases, hp and the noise rounded by r."""
  return (r(x), [r(w) for w in ws], [r(b) for b in bs],
          None if hp is None else r(hp), r(vareps))


def fused_block_fwd_plain(x, w0, w1, w2, b0, b1, b2, hp, vareps, n: int,
                          offset: int, table, preact: bool,
                          compute_dtype=torch.float32):
  """(y, logdet, u) with plain tensor ops: y = x + g(x),
  u = vareps + sum_k (-1)^k coeff(k) (J^T)^k vareps,
  logdet = <J^T u, vareps> per sample.

  In bfloat16 the values are those of `_fwd_body` with cdt = bfloat16
  (`fused_block.py:196-275`), held in float32: x, the weights, biases, hp
  and the chain's vareps rounded first; every product summed in float32
  and rounded, the bias added and rounded again; sigma and sigma' taken
  from the rounded value and rounded; each diagonal multiply rounded.
  g = conv(s2, W2) + b2, y = x + g, the chain's acc, u and the log-det
  stay float32."""
  r = rounder(compute_dtype)
  xc, (w0, w1, w2), (b0, b1, b2), hp, eps_c = _operands(
      r, x, (w0, w1, w2), (b0, b1, b2), hp, vareps)
  _, d0, _, _, d1, s2, d2 = _forward_layers(xc, w0, w1, b0, b1, hp, preact,
                                            r)
  if r is _exact:
    y = xc + F.conv2d(s2, w2, b2, padding=1)
  else:
    y = xc + (F.conv2d(s2, w2, padding=1) + b2[None, :, None, None])
  w2t, w1t, w0t = _transposed(w0, w1, w2)

  def jt(v):
    t = r(r(F.conv2d(v, w2t, padding=1)) * d2)
    t = r(r(F.conv2d(t, w1t)) * d1)
    t = r(F.conv2d(t, w0t, padding=1))
    return t if d0 is None else r(t * d0)

  acc, v = torch.zeros_like(vareps), eps_c
  for c in neumann.chain_coeffs(int(n), int(offset), table):
    v = jt(v)
    acc = acc + float(c) * v
  u = vareps + acc
  logdet = (jt(r(u)) * vareps).flatten(1).sum(1)
  return y, logdet, u


def fused_block_bwd_plain(x, vareps, u, ybar, lbar, w0, w1, w2, b0, b1, hp,
                          preact: bool, compute_dtype=torch.float32):
  """The gradients of sum(ybar * y) + sum(lbar * logdet) with respect to
  (x, w0, w1, w2, b0, b1, b2, hp), u held constant: the analytic formulas
  of `fused_block.py:43-63` in plain tensor ops (no autograd graph).
  hbar is None without hp.

  In bfloat16 the values are those of `_make_bwd_body` with cdt =
  bfloat16 (`fused_block.py:353-465`): the recompute, the tangent and the
  narrow cotangents as in the forward; z2b and z1b are float32, since the
  float32 constant (2 pi)^2 promotes the sigma'' term there; every weight
  and bias gradient is a float32 sum of the rounded values."""
  r = rounder(compute_dtype)
  xc, (w0, w1, w2), (b0, b1), hp, eps_c = _operands(
      r, x, (w0, w1, w2), (b0, b1), hp, vareps)
  ybar_c, v = r(ybar), r(lbar[:, None, None, None] * u)
  s0, d0, sin1, s1, d1, s2, d2 = _forward_layers(xc, w0, w1, b0, b1, hp,
                                                 preact, r)
  w2t, w1t, w0t = _transposed(w0, w1, w2)
  wgrad = torch.nn.grad.conv2d_weight
  # the tangent J vareps, layer by layer
  t0 = eps_c if d0 is None else r(d0 * eps_c)
  a1 = r(F.conv2d(t0, w0, padding=1))
  t1 = r(d1 * a1)
  a2 = r(F.conv2d(t1, w1))
  t2 = r(d2 * a2)
  # layer 2
  w2g = (wgrad(s2, w2.shape, ybar_c, padding=1)
         + wgrad(t2, w2.shape, v, padding=1))
  b2g = ybar_c.sum((0, 2, 3))
  s2b = r(F.conv2d(ybar_c, w2t, padding=1))
  t2b = r(F.conv2d(v, w2t, padding=1))
  z2b = r(d2 * s2b) - SIG2 * s2 * r(a2 * t2b)
  a2b = r(d2 * t2b)
  # layer 1
  w1g = (torch.einsum("bohw,bihw->oi", z2b, s1)
         + torch.einsum("bohw,bihw->oi", a2b, t1))[:, :, None, None]
  b1g = z2b.sum((0, 2, 3))
  s1b = r(F.conv2d(z2b, w1t))
  t1b = r(F.conv2d(a2b, w1t))
  hbar = None if hp is None else s1b.sum((2, 3))
  z1b = r(d1 * s1b) - SIG2 * sin1 * r(a1 * t1b)
  a1b = r(d1 * t1b)
  # layer 0
  w0g = (wgrad(s0, w0.shape, z1b, padding=1)
         + wgrad(t0, w0.shape, a1b, padding=1))
  b0g = z1b.sum((0, 2, 3))
  s0b = r(F.conv2d(z1b, w0t, padding=1))
  if d0 is None:
    xbar = ybar + s0b
  else:
    t0b = r(F.conv2d(a1b, w0t, padding=1))
    xbar = ybar + r(d0 * s0b) - SIG2 * r(r(s0 * eps_c) * t0b)
  return xbar, w0g, w1g, w2g, b0g, b1g, b2g, hbar


def _kernel(name):
  fn = _fns.get(name)
  if fn is None:
    from indm_torch.ops import build
    fn = getattr(build.load("fused_block.cu"), name)
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "indm_fused_block_fwd":
      fn.argtypes = ([p] * 12 + [ctypes.POINTER(ctypes.c_float), i, i, i]
                     + [p] * 4 + [ctypes.c_int64] + [i] * 5 + [p])
    else:
      fn.argtypes = ([p] * 13 + [i, i] + [p] * 9 + [ctypes.c_int64] + [i] * 5
                     + [p])
    fn.restype = ctypes.c_int
    _fns[name] = fn
  return fn


def _check(x, w0, w1, w2, b0, b1, hp, b2=None, narrow=(), lbar=None,
           what="fused_block", compute_dtype=torch.float32):
  """Raise ValueError on any input the kernels do not take. The inputs are
  float32 in either mode; bfloat16 needs H*W and the width to be
  multiples of 8 (a 16-byte copy holds 8 bfloat16)."""
  def bad(msg):
    raise ValueError(f"{what}: {msg}")

  rounder(compute_dtype)
  if x.dim() != 4:
    bad(f"x must be NCHW, got {tuple(x.shape)}")
  b, c, h, w = x.shape
  idim = w0.shape[0]
  align = 4 if compute_dtype == torch.float32 else 8
  if c not in CHANNELS:
    bad(f"the kernels are built for {CHANNELS} channels, got {c}"
        + (": CelebA's second flow scale (48 channels after the squeeze) "
           "takes kernel 7 on the chain route, as the JAX package's "
           "fused_chain_ok sends it; the fused kernels there are not built "
           "(flow.fused_block)" if c == 48 else ""))
  if idim < MIN_WIDTH or idim % align or (h * w) % align:
    bad(f"the width ({idim}) must be at least {MIN_WIDTH} and, like H*W "
        f"({h * w}), a multiple of {align} in {compute_dtype}")
  if c * (h + 2) * (w + 2) > MAX_PADDED:
    bad(f"C*(H+2)*(W+2) = {c * (h + 2) * (w + 2)} exceeds {MAX_PADDED}, "
        "the backward's two padded narrow planes in shared memory")
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


def is_bf16(compute_dtype):
  """1 for the kernels' bfloat16 mode, 0 for float32 (and raises on any
  other type)."""
  return int(rounder(compute_dtype) is not _exact)


def kernel_operands(compute_dtype, *ts):
  """The weights, biases and hp as the kernels take them: float32 as they
  are, or cast to contiguous bfloat16 for the bfloat16 mode, as the TPU
  pair casts them outside its body; None stays None."""
  cast = is_bf16(compute_dtype)
  return [None if t is None else
          (t.to(torch.bfloat16) if cast else t).contiguous() for t in ts]


def plane_floats(idim):
  """One block's TF32 planes of W1 and W1^T for the forward's `wgmma`
  products (`plane_floats` of `csrc/fused_block_ops.cuh`): 4*I*I8 floats,
  I8 = I rounded up to a multiple of 8."""
  return 4 * idim * lipnet_gemm.padded_k(idim)


def fwd_scratch_floats(b, c, hw, idim, blocks=1):
  """The forward's scratch for `blocks` blocks' weight planes and one
  block's temporaries (`fwd_scratch` of `csrc/fused_block_ops.cuh`):
  kernel 3's with one block, in float32."""
  return blocks * plane_floats(idim) + 4 * b * idim * hw + 5 * b * c * hw


def bwd_scratch_floats(b, c, hw, idim):
  """Kernel 4's scratch in float32 (`bwd_scratch` of
  `csrc/fused_block_ops.cuh`)."""
  return (11 * b * idim * hw + 6 * b * c * hw + b * idim * idim
          + 18 * b * idim * c + 2 * b * idim + b * c)


def fwd_scratch_bytes(b, c, hw, idim, compute_dtype, blocks=1):
  """Kernel 3's scratch in bytes (kernel 5's without the transposed
  convs): float32's floats, or in bfloat16 `fwd_scratch_bytes` of
  `csrc/fused_block_ops.cuh` (no weight planes)."""
  if not is_bf16(compute_dtype):
    return 4 * fwd_scratch_floats(b, c, hw, idim, blocks)
  return 8 * b * idim * hw + 18 * b * c * hw


def bwd_scratch_bytes(b, c, hw, idim, compute_dtype):
  """Kernel 4's scratch in bytes: float32's floats, or in bfloat16
  `bwd_scratch_bytes` of `csrc/fused_block_ops.cuh`."""
  if not is_bf16(compute_dtype):
    return 4 * bwd_scratch_floats(b, c, hw, idim)
  return (28 * b * idim * hw + 16 * b * c * hw
          + 4 * (b * idim * idim + 18 * b * idim * c + 2 * b * idim + b * c))


def scratch(nbytes, device):
  """An uninitialised byte buffer for a kernel's scratch."""
  return torch.empty(nbytes, dtype=torch.uint8, device=device)


def fused_block_fwd(x, w0, w1, w2, b0, b1, b2, hp, vareps, n: int,
                    offset: int, table, preact: bool,
                    compute_dtype=torch.float32):
  """(y, logdet, u) of one block, float32, computed in `compute_dtype`
  (float32 or bfloat16). A CPU tensor takes the plain version; a CUDA
  tensor launches kernel 3 on the current stream (and raises on any input
  it does not take)."""
  global fwd_launches
  if x.device.type == "cpu":
    return fused_block_fwd_plain(x, w0, w1, w2, b0, b1, b2, hp, vareps, n,
                                 offset, table, preact, compute_dtype)
  if x.device.type != "cuda":
    raise ValueError(f"fused_block_fwd runs on cpu or cuda, not {x.device}")
  _check(x, w0, w1, w2, b0, b1, hp, b2=b2, narrow=[("vareps", vareps)],
         compute_dtype=compute_dtype)
  b, c, h, w = x.shape
  idim = w0.shape[0]
  coeffs = neumann.chain_coeffs(int(n), int(offset), table)
  w0, w1, w2, b0, b1, b2, hp = kernel_operands(compute_dtype, w0, w1, w2, b0,
                                               b1, b2, hp)
  w2t, w1t, w0t = _transposed(w0, w1, w2)
  y, u = torch.empty_like(x), torch.empty_like(x)
  logdet = torch.empty(b, device=x.device)
  buf = scratch(fwd_scratch_bytes(b, c, h * w, idim, compute_dtype),
                x.device)
  _device_call(x, _kernel("indm_fused_block_fwd"), x.data_ptr(),
               vareps.data_ptr(), w0.data_ptr(), w1.data_ptr(),
               w2.data_ptr(), w2t.data_ptr(), w1t.data_ptr(), w0t.data_ptr(),
               b0.data_ptr(), b1.data_ptr(), b2.data_ptr(), _ptr(hp),
               coeffs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
               len(coeffs), int(preact), is_bf16(compute_dtype), y.data_ptr(),
               u.data_ptr(), logdet.data_ptr(), buf.data_ptr(), buf.numel(),
               b, c, h, w, idim)
  fwd_launches += 1
  return y, logdet, u


def fused_block_bwd(x, vareps, u, ybar, lbar, w0, w1, w2, b0, b1, hp,
                    preact: bool, compute_dtype=torch.float32):
  """(xbar, w0g, w1g, w2g, b0g, b1g, b2g, hbar) of one block for the
  cotangents (ybar, lbar), float32, computed in `compute_dtype`. A CPU
  tensor takes the plain version; a CUDA tensor launches kernel 4 on the
  current stream (and raises on any input it does not take)."""
  global bwd_launches
  if x.device.type == "cpu":
    return fused_block_bwd_plain(x, vareps, u, ybar, lbar, w0, w1, w2, b0,
                                 b1, hp, preact, compute_dtype)
  if x.device.type != "cuda":
    raise ValueError(f"fused_block_bwd runs on cpu or cuda, not {x.device}")
  _check(x, w0, w1, w2, b0, b1, hp, lbar=lbar,
         narrow=[("vareps", vareps), ("u", u), ("ybar", ybar)],
         compute_dtype=compute_dtype)
  b, c, h, w = x.shape
  idim = w0.shape[0]
  xbar = torch.empty_like(x)
  w0g, w1g, w2g = (torch.empty_like(t) for t in (w0, w1, w2))
  b0g, b1g = torch.empty_like(b0), torch.empty_like(b1)
  b2g = torch.empty(c, device=x.device)
  hbar = None if hp is None else torch.empty_like(hp)
  w0, w1, w2, b0, b1, hp = kernel_operands(compute_dtype, w0, w1, w2, b0, b1,
                                           hp)
  w2t, w1t, w0t = _transposed(w0, w1, w2)
  buf = scratch(bwd_scratch_bytes(b, c, h * w, idim, compute_dtype),
                x.device)
  _device_call(x, _kernel("indm_fused_block_bwd"), x.data_ptr(),
               vareps.data_ptr(), u.data_ptr(), ybar.data_ptr(),
               lbar.data_ptr(), w0.data_ptr(), w1.data_ptr(), w2t.data_ptr(),
               w1t.data_ptr(), w0t.data_ptr(), b0.data_ptr(), b1.data_ptr(),
               _ptr(hp), int(preact), is_bf16(compute_dtype),
               xbar.data_ptr(), w0g.data_ptr(), w1g.data_ptr(),
               w2g.data_ptr(), b0g.data_ptr(), b1g.data_ptr(),
               b2g.data_ptr(), _ptr(hbar), buf.data_ptr(), buf.numel(), b,
               c, h, w, idim)
  bwd_launches += 1
  return xbar, w0g, w1g, w2g, b0g, b1g, b2g, hbar


class FusedBlockFn(torch.autograd.Function):
  """(y, logdet) of one block through `fused_block_fwd`, with its backward
  through `fused_block_bwd`. Inputs: x, the three normalised weights, the
  three biases, hp (or None), vareps, n, offset, table, preact and the
  compute type. It saves (x, weights, b0, b1, hp, vareps, u), the
  residuals of the TPU pair's custom VJP (`_fused_fwd`), and recomputes
  the rest in the backward."""

  @staticmethod
  def forward(ctx, x, w0, w1, w2, b0, b1, b2, hp, vareps, n, offset, table,
              preact, compute_dtype=torch.float32):
    y, logdet, u = fused_block_fwd(x, w0, w1, w2, b0, b1, b2, hp, vareps, n,
                                   offset, table, preact, compute_dtype)
    ctx.save_for_backward(x, w0, w1, w2, b0, b1, hp, vareps, u)
    ctx.preact = preact
    ctx.compute_dtype = compute_dtype
    return y, logdet

  @staticmethod
  def backward(ctx, ybar, lbar):
    x, w0, w1, w2, b0, b1, hp, vareps, u = ctx.saved_tensors
    ybar = torch.zeros_like(x) if ybar is None else ybar.contiguous()
    lbar = (x.new_zeros(x.shape[0]) if lbar is None else lbar.contiguous())
    grads = fused_block_bwd(x, vareps, u, ybar, lbar, w0, w1, w2, b0, b1, hp,
                            ctx.preact, ctx.compute_dtype)
    return (*grads, None, None, None, None, None, None)
