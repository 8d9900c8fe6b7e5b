"""The fused-stack kernel pair: every pre-activated iResBlock of one scale in
one call per direction, the training forward of each block with its log-det
estimator and the complete backward walked in reverse. Hopper kernels and
their plain versions.

Counterpart of `indm_tpu/ops/fused_stack.py`. `fused_stack_fwd` and
`fused_stack_bwd` are the wrappers: on a CUDA tensor they launch the
hand-written kernels of `indm_torch/csrc/fused_stack.cu` (which replace the
TPU kernels `fused_stack_fwd_pallas` and `fused_stack_bwd_pallas`) or
raise; on a CPU tensor they compute `fused_stack_fwd_plain` and
`fused_stack_bwd_plain`, the fused block's plain versions looped over the
blocks as `fused_stack_reference` loops `fused_block_reference`.
`FusedStackFn` is the custom VJP around them (`fused_stack_apply`). The
kernels' design and their bound are in the source's note.

Layout and weights are those of `indm_torch.ops.fused_block`, stacked on a
leading block axis: w0s [n, I, C, 3, 3], w1s [n, I, I, 1, 1],
w2s [n, C, I, 3, 3], b0s and b1s [n, I], b2s [n, C], hp_all [n, B, I] (or
None), vareps_all [n, B, C, H, W], and n_all, the n host draws.

`compute_dtype` selects the mode, float32 or bfloat16, as for the fused
block (`fused_block.rounder`).

`fwd_launches` and `bwd_launches` count the wrapper calls that launched
each kernel (one call runs the whole stack on one stream).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from indm_torch.ops import fused_block as fb

fwd_launches = 0
bwd_launches = 0

_fns = {}


def reset_launches():
  global fwd_launches, bwd_launches
  fwd_launches = bwd_launches = 0


def _block(t, j):
  return None if t is None else t[j]


def fused_stack_fwd_plain(x, w0s, w1s, w2s, b0s, b1s, b2s, hp_all,
                          vareps_all, n_all, offset: int, table,
                          preact: bool, compute_dtype=torch.float32):
  """(y, ld_all [n, B], u_all, xs_all [n, B, C, H, W]) with plain tensor
  ops: `fused_block_fwd_plain` in `compute_dtype` on each block in order,
  xs_all[j] the input of block j (float32, as the TPU kernel's carry)."""
  lds, us, xs = [], [], []
  for j, n in enumerate(n_all):
    xs.append(x)
    x, ld, u = fb.fused_block_fwd_plain(
        x, w0s[j], w1s[j], w2s[j], b0s[j], b1s[j], b2s[j], _block(hp_all, j),
        vareps_all[j], n, offset, table, preact, compute_dtype)
    lds.append(ld)
    us.append(u)
  return x, torch.stack(lds), torch.stack(us), torch.stack(xs)


def fused_stack_bwd_plain(xs_all, vareps_all, u_all, ybar, lbar, w0s, w1s,
                          w2s, b0s, b1s, hp_all, preact: bool,
                          compute_dtype=torch.float32):
  """(xbar, w0g, w1g, w2g, b0g, b1g, b2g, hbar) with plain tensor ops:
  `fused_block_bwd_plain` from the last block to the first, each block's
  xbar the cotangent of the block before, lbar (the cotangent of the sum
  of the log-dets) the same for every block. The gradients are stacked in
  forward block order; hbar [n, B, I] is None without hp_all."""
  per_block = [None] * xs_all.shape[0]
  for j in reversed(range(len(per_block))):
    ybar, *per_block[j] = fb.fused_block_bwd_plain(
        xs_all[j], vareps_all[j], u_all[j], ybar, lbar, w0s[j], w1s[j],
        w2s[j], b0s[j], b1s[j], _block(hp_all, j), preact, compute_dtype)
  return (ybar, *(None if g[0] is None else torch.stack(g)
                  for g in zip(*per_block)))


def _kernel(name):
  fn = _fns.get(name)
  if fn is None:
    from indm_torch.ops import build
    fn = getattr(build.load("fused_stack.cu"), name)
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "indm_fused_stack_fwd":
      fn.argtypes = ([p, p, ctypes.POINTER(ctypes.c_int), i,
                      ctypes.POINTER(ctypes.c_float), i, i] + [p] * 7
                     + [i, i] + [p] * 5 + [ctypes.c_int64] + [i] * 5 + [p])
    else:
      fn.argtypes = ([p] * 5 + [i] + [p] * 6 + [i, i] + [p] * 9
                     + [ctypes.c_int64] + [i] * 5 + [p])
    fn.restype = ctypes.c_int
    _fns[name] = fn
  return fn


def _check(x, nb, w0s, w1s, w2s, b0s, b1s, hp_all, b2s=None, n_all=(),
           stacked=(), narrow=(), lbar=None, compute_dtype=torch.float32):
  """Raise ValueError on any input the kernels do not take: every stacked
  tensor contiguous with one entry per block, and block 0's slices by the
  rules of the fused block's kernels (`fused_block._check`)."""
  def bad(msg):
    raise ValueError(f"fused_stack: {msg}")

  if nb < 1 or any(n < 0 for n in n_all):
    bad(f"needs one or more blocks and draws n >= 0, got {nb} and "
        f"{list(n_all)}")
  named = [("w0s", w0s), ("w1s", w1s), ("w2s", w2s), ("b0s", b0s),
           ("b1s", b1s), ("b2s", b2s), ("hp_all", hp_all), *stacked]
  for name, t in named:
    if t is not None and (t.dim() < 2 or t.shape[0] != nb
                          or not t.is_contiguous()):
      bad(f"{name} must be contiguous with {nb} blocks on its first axis, "
          f"got {tuple(t.shape)}")
  fb._check(x, w0s[0], w1s[0], w2s[0], b0s[0], b1s[0], _block(hp_all, 0),
            b2=_block(b2s, 0), lbar=lbar, what="fused_stack",
            narrow=[(name, t[0]) for name, t in stacked] + list(narrow),
            compute_dtype=compute_dtype)


def _transposed_floats(nb, c, idim):
  """The transposed convs of every block at the front of the scratch."""
  return nb * (18 * idim * c + idim * idim)


def fwd_scratch_floats(nb, b, c, hw, idim):
  """Kernel 5's scratch in float32: the transposed convs, every block's W1
  and W1^T planes, one block's temporaries (`indm_fused_stack_fwd`'s
  comment in `csrc/fused_stack.cu`)."""
  return _transposed_floats(nb, c, idim) + fb.fwd_scratch_floats(
      b, c, hw, idim, nb)


def fwd_scratch_bytes(nb, b, c, hw, idim, compute_dtype):
  """Kernel 5's scratch in bytes (`stack_fwd_bytes` of
  `csrc/fused_stack.cu`): in bfloat16 the transposed convs in bfloat16 and
  kernel 3's bfloat16 temporaries."""
  if not fb.is_bf16(compute_dtype):
    return 4 * fwd_scratch_floats(nb, b, c, hw, idim)
  return (2 * _transposed_floats(nb, c, idim)
          + fb.fwd_scratch_bytes(b, c, hw, idim, compute_dtype))


def bwd_scratch_bytes(nb, b, c, hw, idim, compute_dtype):
  """Kernel 6's scratch in bytes (`stack_bwd_bytes` of
  `csrc/fused_stack.cu`): the transposed convs in the compute type, the
  float32 carry and kernel 4's scratch."""
  return (_transposed_floats(nb, c, idim) * (2 if fb.is_bf16(compute_dtype)
                                             else 4)
          + 4 * b * c * hw
          + fb.bwd_scratch_bytes(b, c, hw, idim, compute_dtype))


def fused_stack_fwd(x, w0s, w1s, w2s, b0s, b1s, b2s, hp_all, vareps_all,
                    n_all, offset: int, table, preact: bool,
                    compute_dtype=torch.float32):
  """(y, ld_all, u_all, xs_all) of a stack of blocks, float32, computed in
  `compute_dtype`. A CPU tensor takes the plain version; a CUDA tensor
  launches kernel 5 on the current stream (and raises on any input it does
  not take)."""
  global fwd_launches
  n_all = [int(n) for n in n_all]
  if x.device.type == "cpu":
    return fused_stack_fwd_plain(x, w0s, w1s, w2s, b0s, b1s, b2s, hp_all,
                                 vareps_all, n_all, offset, table, preact,
                                 compute_dtype)
  if x.device.type != "cuda":
    raise ValueError(f"fused_stack_fwd runs on cpu or cuda, not {x.device}")
  nb = len(n_all)
  _check(x, nb, w0s, w1s, w2s, b0s, b1s, hp_all, b2s=b2s, n_all=n_all,
         stacked=[("vareps_all", vareps_all)], compute_dtype=compute_dtype)
  b, c, h, w = x.shape
  idim = w0s.shape[1]
  y = torch.empty_like(x)
  ld_all = torch.empty(nb, b, device=x.device)
  u_all, xs_all = torch.empty_like(vareps_all), torch.empty_like(vareps_all)
  w0s, w1s, w2s, b0s, b1s, b2s, hp_all = fb.kernel_operands(
      compute_dtype, w0s, w1s, w2s, b0s, b1s, b2s, hp_all)
  buf = fb.scratch(fwd_scratch_bytes(nb, b, c, h * w, idim, compute_dtype),
                   x.device)
  n_arr = np.ascontiguousarray(n_all, np.int32)
  tab = np.ascontiguousarray(table, np.float32)
  fb._device_call(x, _kernel("indm_fused_stack_fwd"), x.data_ptr(),
                  vareps_all.data_ptr(),
                  n_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), nb,
                  tab.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(tab),
                  int(offset), w0s.data_ptr(), w1s.data_ptr(),
                  w2s.data_ptr(), b0s.data_ptr(), b1s.data_ptr(),
                  b2s.data_ptr(), fb._ptr(hp_all), int(preact),
                  fb.is_bf16(compute_dtype), y.data_ptr(), ld_all.data_ptr(),
                  u_all.data_ptr(), xs_all.data_ptr(), buf.data_ptr(),
                  buf.numel(), b, c, h, w, idim)
  fwd_launches += 1
  return y, ld_all, u_all, xs_all


def fused_stack_bwd(xs_all, vareps_all, u_all, ybar, lbar, w0s, w1s, w2s,
                    b0s, b1s, hp_all, preact: bool,
                    compute_dtype=torch.float32):
  """(xbar, w0g, w1g, w2g, b0g, b1g, b2g, hbar) of a stack of blocks for
  the cotangents (ybar, lbar), in forward block order, float32, computed
  in `compute_dtype`. A CPU tensor takes the plain version; a CUDA tensor
  launches kernel 6 on the current stream (and raises on any input it
  does not take)."""
  global bwd_launches
  if xs_all.device.type == "cpu":
    return fused_stack_bwd_plain(xs_all, vareps_all, u_all, ybar, lbar, w0s,
                                 w1s, w2s, b0s, b1s, hp_all, preact,
                                 compute_dtype)
  if xs_all.device.type != "cuda":
    raise ValueError(f"fused_stack_bwd runs on cpu or cuda, not "
                     f"{xs_all.device}")
  nb = xs_all.shape[0]
  _check(xs_all[0], nb, w0s, w1s, w2s, b0s, b1s, hp_all,
         stacked=[("xs_all", xs_all), ("vareps_all", vareps_all),
                  ("u_all", u_all)], narrow=[("ybar", ybar)], lbar=lbar,
         compute_dtype=compute_dtype)
  _, b, c, h, w = xs_all.shape
  idim = w0s.shape[1]
  xbar = torch.empty_like(ybar)
  w0g, w1g, w2g, b0g, b1g = (torch.empty_like(t)
                             for t in (w0s, w1s, w2s, b0s, b1s))
  b2g = torch.empty(nb, c, device=xs_all.device)
  hbar = None if hp_all is None else torch.empty_like(hp_all)
  w0s, w1s, w2s, b0s, b1s, hp_all = fb.kernel_operands(
      compute_dtype, w0s, w1s, w2s, b0s, b1s, hp_all)
  buf = fb.scratch(bwd_scratch_bytes(nb, b, c, h * w, idim, compute_dtype),
                   xs_all.device)
  fb._device_call(xs_all, _kernel("indm_fused_stack_bwd"), xs_all.data_ptr(),
                  vareps_all.data_ptr(), u_all.data_ptr(), ybar.data_ptr(),
                  lbar.data_ptr(), nb, w0s.data_ptr(), w1s.data_ptr(),
                  w2s.data_ptr(), b0s.data_ptr(), b1s.data_ptr(),
                  fb._ptr(hp_all), int(preact), fb.is_bf16(compute_dtype),
                  xbar.data_ptr(), w0g.data_ptr(), w1g.data_ptr(),
                  w2g.data_ptr(), b0g.data_ptr(), b1g.data_ptr(),
                  b2g.data_ptr(), fb._ptr(hbar), buf.data_ptr(), buf.numel(),
                  b, c, h, w, idim)
  bwd_launches += 1
  return xbar, w0g, w1g, w2g, b0g, b1g, b2g, hbar


class FusedStackFn(torch.autograd.Function):
  """(y, ld_sum) of a stack of blocks through `fused_stack_fwd`, with its
  backward through `fused_stack_bwd`; ld_sum [B] is the sum of the blocks'
  log-dets, as `fused_stack_apply` returns it. Inputs: x, the stacked
  normalised weights and biases, hp_all (or None), vareps_all, n_all,
  offset, table, preact and the compute type. It saves the residuals of
  the TPU pair's custom VJP (`_stack_fwd`): the weights, b0s, b1s, hp_all,
  vareps_all, u_all and xs_all."""

  @staticmethod
  def forward(ctx, x, w0s, w1s, w2s, b0s, b1s, b2s, hp_all, vareps_all,
              n_all, offset, table, preact, compute_dtype=torch.float32):
    y, ld_all, u_all, xs_all = fused_stack_fwd(
        x, w0s, w1s, w2s, b0s, b1s, b2s, hp_all, vareps_all, n_all, offset,
        table, preact, compute_dtype)
    ctx.save_for_backward(w0s, w1s, w2s, b0s, b1s, hp_all, vareps_all, u_all,
                          xs_all)
    ctx.preact = preact
    ctx.compute_dtype = compute_dtype
    return y, ld_all.sum(0)

  @staticmethod
  def backward(ctx, ybar, lbar):
    (w0s, w1s, w2s, b0s, b1s, hp_all, vareps_all, u_all,
     xs_all) = ctx.saved_tensors
    x = xs_all[0]
    ybar = torch.zeros_like(x) if ybar is None else ybar.contiguous()
    lbar = x.new_zeros(x.shape[0]) if lbar is None else lbar.contiguous()
    grads = fused_stack_bwd(xs_all, vareps_all, u_all, ybar, lbar, w0s, w1s,
                            w2s, b0s, b1s, hp_all, ctx.preact,
                            ctx.compute_dtype)
    return (*grads, None, None, None, None, None, None)
