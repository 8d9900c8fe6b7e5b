"""The iResBlock log-det estimator's stop-gradient Neumann chain: the Hopper
kernel and its plain version.

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

`launches` counts the calls of `neumann_chain` that launched the kernel
(one call runs 3 * (n + offset) CUDA launches).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

CHANNELS = (3, 12)

launches = 0

_fn = None


def reset_launches():
  global launches
  launches = 0


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
