"""The iResBlock log-det estimator's stop-gradient Neumann chain: the Hopper
kernels and their plain versions.

`neumann_chain` is the wrapper the residual flow calls in training. On a
CUDA tensor it launches the hand-written kernel of
`indm_torch/csrc/neumann_chain.cu` (which replaces the TPU kernel
`indm_tpu/ops/neumann_pallas.py:neumann_chain_pallas`) or raises; on a CPU
tensor it computes `neumann_chain_plain`. The kernel's design and its
bound are in the source's note.

Layout is NCHW. `dacts` are the activation-derivative diagonals in
application order, `[d_out, d_mid]` plus `d_in` for a pre-activated block;
`weights_t` the transposed conv weights in application order
(`transpose_conv_weight` of the Lipschitz net's last, middle and first
conv). n is a host int (the Russian-roulette draw), so the number of terms
is known on the host.

`fused_neumann_chain` is the same chain with the diagonals made from the
block input in the same call, the JAX package's route under
INDM_FUSED_CHAIN=1: on a CUDA tensor it launches the kernel of
`indm_torch/csrc/fused_chain.cu` (which replaces
`neumann_pallas.fused_neumann_chain_pallas`) or raises; on a CPU tensor it
computes `fused_neumann_chain_plain`. `fused_chain_inputs` packs its
weights from an iResBlock, as `neumann_pallas.fused_chain_inputs` does.

`launches` counts the calls of `neumann_chain` that launched the kernel
(one call runs 3 * (n + offset) CUDA launches), `fused_launches` those of
`fused_neumann_chain`.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
import torch.nn.functional as F

CHANNELS = (3, 12)

launches = 0
fused_launches = 0

_fn = None
_fused_fn = None


def reset_launches():
  global launches, fused_launches
  launches = fused_launches = 0


def transpose_conv_weight(w: torch.Tensor) -> torch.Tensor:
  """[O, I, k, k] conv weight -> the weight of its transposed (VJP) conv,
  [I, O, k, k]: spatial flip and in/out swap (stride 1, odd k, same
  padding). The counterpart of `neumann_pallas.transpose_conv_kernel`."""
  return w.flip(2, 3).transpose(0, 1)


def chain_coeffs(n: int, offset: int, table) -> np.ndarray:
  """(-1)^k coeff(k) for k = 1..n+offset in float32, coeff(k) =
  1{n >= k - offset} / table[min(k, len - 1)], as the TPU kernel computes
  them."""
  table = np.asarray(table, np.float32)
  ks = np.arange(1, n + offset + 1)
  ind = (n >= ks - offset).astype(np.float32)
  coeff = ind / table[np.minimum(ks, len(table) - 1)]
  sign = np.where(ks % 2 == 1, np.float32(-1.0), np.float32(1.0))
  return (sign * coeff).astype(np.float32)


def neumann_chain_plain(vareps, dacts, weights_t, n: int, offset: int, table):
  """acc = sum_{k=1}^{n+offset} (-1)^k coeff(k) (J^T)^k vareps with plain
  tensor ops: the arithmetic of `neumann_chain_ref`, NCHW."""
  acc = torch.zeros_like(vareps, dtype=torch.float32)
  v = vareps
  for c in chain_coeffs(n, offset, table):
    for i, w in enumerate(weights_t):
      v = F.conv2d(v, w, padding=w.shape[-1] // 2)
      if i < len(dacts):
        v = v * dacts[i]
    acc = acc + float(c) * v
  return acc


def _kernel():
  global _fn
  if _fn is None:
    from indm_torch.ops import build
    fn = build.load("neumann_chain.cu").indm_neumann_chain
    fn.argtypes = ([ctypes.c_void_p] * 7
                   + [ctypes.POINTER(ctypes.c_float), ctypes.c_int]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _fn = fn
  return _fn


def _check(vareps, dacts, weights_t):
  def bad(msg):
    raise ValueError(f"neumann_chain: {msg}")

  if vareps.dim() != 4:
    bad(f"vareps must be NCHW, got {tuple(vareps.shape)}")
  b, c, h, w = vareps.shape
  if c not in CHANNELS:
    bad(f"the kernel is built for {CHANNELS} channels, got {c}")
  if len(weights_t) != 3 or len(dacts) not in (2, 3):
    bad("needs three transposed weights and two or three diagonals")
  idim = weights_t[0].shape[0]
  want_w = [(idim, c, 3, 3), (idim, idim, 1, 1), (c, idim, 3, 3)]
  want_d = [(b, idim, h, w), (b, idim, h, w), (b, c, h, w)][:len(dacts)]
  if (h * w) % 4 or idim % 4:
    bad(f"H*W ({h * w}) and the width ({idim}) must be multiples of 4")
  for name, ts, shapes in (("weights_t", weights_t, want_w),
                           ("dacts", dacts, want_d),
                           ("vareps", [vareps], [(b, c, h, w)])):
    for t, shape in zip(ts, shapes):
      if tuple(t.shape) != shape:
        bad(f"{name}: expected {shape}, got {tuple(t.shape)}")
      if t.dtype != torch.float32 or not t.is_contiguous() or \
          t.device != vareps.device:
        bad(f"{name} must be contiguous float32 on {vareps.device}")
  if vareps.numel() * idim // c >= 2 ** 31:
    bad("the kernel indexes one sample with 32-bit ints")


def neumann_chain(vareps, dacts, weights_t, n: int, offset: int, table):
  """The chain's acc [B, C, H, W] float32 (the caller adds vareps for u).

  A CPU tensor takes the plain version; a CUDA tensor launches the kernel
  on the current stream (and raises on any input it does not take)."""
  global launches
  if vareps.device.type == "cpu":
    return neumann_chain_plain(vareps, dacts, weights_t, n, offset, table)
  if vareps.device.type != "cuda":
    raise ValueError(f"neumann_chain runs on cpu or cuda, not "
                     f"{vareps.device}")
  _check(vareps, dacts, weights_t)
  b, c, h, w = vareps.shape
  idim = weights_t[0].shape[0]
  coeffs = chain_coeffs(int(n), int(offset), table)
  acc = torch.empty_like(vareps)
  v = torch.empty_like(vareps)
  t1 = torch.empty((b, idim, h, w), device=vareps.device)
  t2 = torch.empty_like(t1)
  d_in = dacts[2].data_ptr() if len(dacts) == 3 else None
  fn = _kernel()
  with torch.cuda.device(vareps.device):
    stream = torch.cuda.current_stream(vareps.device).cuda_stream
    rc = fn(vareps.data_ptr(), dacts[0].data_ptr(), dacts[1].data_ptr(),
            d_in, weights_t[0].data_ptr(), weights_t[1].data_ptr(),
            weights_t[2].data_ptr(),
            coeffs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(coeffs), acc.data_ptr(), v.data_ptr(), t1.data_ptr(),
            t2.data_ptr(), b, c, h, w, idim, stream)
  if rc != 0:
    raise RuntimeError(f"neumann_chain kernel launch failed with CUDA error "
                       f"{rc}")
  launches += 1
  return acc


# ---- the fully fused chain (INDM_FUSED_CHAIN=1) ----


def fused_chain_inputs(block, h):
  """(fwd_mats, biases, weights_t, hp) of an iResBlock for
  `fused_neumann_chain`: the forward weights W0 [I, C, 3, 3] and W1 [I, I],
  the biases b0 and b1, the transposed weights in `neumann_chain`'s layout
  (W2^T, W1^T, W0^T; `transpose_conv_weight`) and hp [B, I] or None, every
  weight normalised by `LopConv2d.normalized_weight` as the net's forward
  normalises it. Run it under no_grad."""
  w0, w1, w2 = (c.normalized_weight() for c in block.convs())
  b0, b1 = (c.bias for c in block.convs()[:2])
  weights_t = [transpose_conv_weight(w).contiguous() for w in (w2, w1, w0)]
  return (w0, w1[:, :, 0, 0]), (b0, b1), weights_t, block.h_projection(h)


def _sin_act(z):
  return torch.sin(2.0 * math.pi * z) / math.pi * 0.5


def fused_neumann_chain_plain(x, vareps, fwd_mats, biases, weights_t, hp,
                              n: int, offset: int, table, preact: bool):
  """The chain's acc with the diagonals made from x in plain tensor ops:
  the arithmetic of the Pallas body (`neumann_pallas.py:366-420`), NCHW.
  d0 = cos 2 pi x and s = sin_act(x) if preact, else s = x; z1 = W0 s + b0,
  d1 = cos 2 pi z1, s1 = sin_act(z1) + hp; z2 = W1 s1 + b1,
  d2 = cos 2 pi z2; then `neumann_chain_plain` on [d2, d1, (d0)]."""
  w0, w1 = fwd_mats
  b0, b1 = biases
  s = _sin_act(x) if preact else x
  z1 = F.conv2d(s, w0, b0, padding=1)
  s1 = _sin_act(z1)
  if hp is not None:
    s1 = s1 + hp[:, :, None, None]
  z2 = F.conv2d(s1, w1[:, :, None, None], b1)
  dacts = [torch.cos(2.0 * math.pi * z2), torch.cos(2.0 * math.pi * z1)]
  if preact:
    dacts.append(torch.cos(2.0 * math.pi * x))
  return neumann_chain_plain(vareps, dacts, weights_t, n, offset, table)


def _fused_kernel():
  global _fused_fn
  if _fused_fn is None:
    from indm_torch.ops import build
    fn = build.load("fused_chain.cu").indm_fused_neumann_chain
    fn.argtypes = ([ctypes.c_void_p] * 10
                   + [ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int64] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _fused_fn = fn
  return _fused_fn


def _check_fused(x, vareps, fwd_mats, biases, weights_t, hp):
  def bad(msg):
    raise ValueError(f"fused_neumann_chain: {msg}")

  if x.dim() != 4:
    bad(f"x must be NCHW, got {tuple(x.shape)}")
  b, c, h, w = x.shape
  if c not in CHANNELS:
    bad(f"the kernel is built for {CHANNELS} channels, got {c}")
  if len(fwd_mats) != 2 or len(biases) != 2 or len(weights_t) != 3:
    bad("needs two forward weights, two biases and three transposed "
        "weights")
  idim = fwd_mats[0].shape[0]
  if (h * w) % 4 or idim % 4:
    bad(f"H*W ({h * w}) and the width ({idim}) must be multiples of 4")
  if b * idim * h * w >= 2 ** 31:
    bad("the kernel indexes one sample with 32-bit ints")
  want = [("x", x, (b, c, h, w)), ("vareps", vareps, (b, c, h, w)),
          ("w0", fwd_mats[0], (idim, c, 3, 3)),
          ("w1", fwd_mats[1], (idim, idim)), ("b0", biases[0], (idim,)),
          ("b1", biases[1], (idim,)),
          ("w2t", weights_t[0], (idim, c, 3, 3)),
          ("w1t", weights_t[1], (idim, idim, 1, 1)),
          ("w0t", weights_t[2], (c, idim, 3, 3))]
  if hp is not None:
    want.append(("hp", hp, (b, idim)))
  for name, t, shape in want:
    if tuple(t.shape) != shape:
      bad(f"{name}: expected {shape}, got {tuple(t.shape)}")
    if (t.dtype != torch.float32 or not t.is_contiguous()
        or t.device != x.device or t.data_ptr() % 16):
      bad(f"{name} must be a contiguous, 16-byte aligned float32 tensor on "
          f"{x.device}")


def fused_neumann_chain(x, vareps, fwd_mats, biases, weights_t, hp, n: int,
                        offset: int, table, preact: bool):
  """The chain's acc [B, C, H, W] float32 for the block input x (the
  caller adds vareps for u). A CPU tensor takes the plain version; a CUDA
  tensor launches the kernel on the current stream (and raises on any
  input it does not take)."""
  global fused_launches
  if x.device.type == "cpu":
    return fused_neumann_chain_plain(x, vareps, fwd_mats, biases, weights_t,
                                     hp, n, offset, table, preact)
  if x.device.type != "cuda":
    raise ValueError(f"fused_neumann_chain runs on cpu or cuda, not "
                     f"{x.device}")
  _check_fused(x, vareps, fwd_mats, biases, weights_t, hp)
  b, c, h, w = x.shape
  idim = fwd_mats[0].shape[0]
  coeffs = chain_coeffs(int(n), int(offset), table)
  acc = torch.empty_like(x)
  # s1, d1, d2, t2 and s0, d0, v (`indm_fused_chain_scratch`)
  scratch = torch.empty(4 * b * idim * h * w + 3 * b * c * h * w,
                        device=x.device)
  fn = _fused_kernel()
  with torch.cuda.device(x.device):
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), vareps.data_ptr(), fwd_mats[0].data_ptr(),
            fwd_mats[1].data_ptr(), biases[0].data_ptr(),
            biases[1].data_ptr(), None if hp is None else hp.data_ptr(),
            weights_t[0].data_ptr(), weights_t[1].data_ptr(),
            weights_t[2].data_ptr(),
            coeffs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(coeffs), int(preact), acc.data_ptr(), scratch.data_ptr(),
            scratch.numel(), b, c, h, w, idim, stream)
  if rc != 0:
    raise RuntimeError(f"fused_neumann_chain kernel launch failed with CUDA "
                       f"error {rc}")
  fused_launches += 1
  return acc
