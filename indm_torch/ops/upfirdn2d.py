"""upfirdn2d and the StyleGAN2 FIR resampling built on it (NCHW).

`upfirdn2d` is the wrapper. On a CUDA tensor it launches the hand-written
kernel of `indm_torch/csrc/upfirdn2d.cu`, which replaces the TPU kernel
`indm_tpu/ops/upfirdn2d_pallas.py:upfirdn2d_pallas`, or raises; on a CPU
tensor it computes `upfirdn2d_plain`, a port of the oracle
`indm_tpu/ops/upfirdn2d.py:upfirdn2d_native`. The resampling functions
(`upsample_2d`, `downsample_2d`, `upsample_conv_2d`, `conv_downsample_2d`)
are ports of the JAX package's, with weights in OIHW.

On a CUDA tensor the kernel runs inside `Upfirdn2dFn`, whose backward is
the same kernel on the adjoint: upfirdn2d of the output's gradient with the
taps flipped, up and down swapped and StyleGAN2's adjoint pads
(`adjoint_pads`). The JAX package differentiates its XLA path
(`indm_tpu/ops/upfirdn2d.py:42-77`) with `jax.grad`. An input whose adjoint
the kernel cannot take raises when a gradient is wanted, so that no output
on the card is ever cut off from autograd.

`launches` counts the forward launches of the kernel and `bwd_launches`
the backward's, so that a run can show that its path went through them.

The kernel's launch plan is chosen here (`plane_plan`, `separate`): a
separable kernel on planes that fit takes the whole-plane kernel, any
other the tile kernel (the source's note).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from indm_torch.ops import build

MAX_TAPS = 8
# the whole-plane kernel's plan (`upfirdn2d.cu`'s note): at most this many
# outputs and this much shared memory a block, at least this many blocks
# where the planes allow (four for each of the H100's 132 SMs), and the
# shared memory a block may take without an opt-in (kSmemBytes)
PLANE_OUTPUTS = 2048
PLANE_SMEM = 24 * 1024
PLANE_MIN_BLOCKS = 4 * 132
SMEM_NO_OPT_IN = 48 * 1024

launches = 0
bwd_launches = 0

_fn = None


def reset_launches():
  global launches, bwd_launches
  launches = bwd_launches = 0


def setup_kernel(k) -> np.ndarray:
  """Outer product (of a 1-D separable kernel) normalised to sum 1,
  float32."""
  k = np.asarray(k, dtype=np.float32)
  if k.ndim == 1:
    k = np.outer(k, k)
  k = k / np.sum(k)
  assert k.ndim == 2 and k.shape[0] == k.shape[1]
  return k


def separate(k2d: np.ndarray):
  """(k_col, k_row), float32, with outer(k_col, k_row) = k2d, or None where
  k2d is not of rank 1. The factorisation of the JAX package's
  `upfirdn2d_pallas.py:_separate`: rank by `matrix_rank` at tol 1e-6, the
  first singular pair scaled by the root of its value, signs so that the
  column sums to at least 0."""
  if np.linalg.matrix_rank(k2d, tol=1e-6) != 1:
    return None
  u, s, vt = np.linalg.svd(k2d)
  k_col = u[:, 0] * np.sqrt(s[0])
  k_row = vt[0] * np.sqrt(s[0])
  if k_col.sum() < 0:
    k_col, k_row = -k_col, -k_row
  return k_col.astype(np.float32), k_row.astype(np.float32)


class Taps(NamedTuple):
  """A kernel as the card takes it: the 2-D taps, their factors (None if
  the kernel is not separable) and the three host addresses."""
  k: np.ndarray
  col: Optional[np.ndarray]
  row: Optional[np.ndarray]
  ptrs: tuple


@functools.lru_cache(maxsize=64)
def _taps_of(shape, raw: bytes) -> Taps:
  k = np.frombuffer(raw, np.float32).reshape(shape).copy()
  sep = separate(k) if k.ndim == 2 else None
  col, row = sep if sep is not None else (None, None)
  ptrs = tuple(a.ctypes.data if a is not None else None
               for a in (k, col, row))
  return Taps(k, col, row, ptrs)


def taps(kernel) -> Taps:
  """`kernel` as a float32 array, factored once for each distinct kernel
  (cached by its bytes)."""
  k = np.ascontiguousarray(kernel, dtype=np.float32)
  return _taps_of(k.shape, k.tobytes())


def plane_smem(ppb: int, h: int, w: int, ow: int) -> int:
  """The whole-plane kernel's shared memory for `ppb` planes: the input,
  16-byte aligned, and the rows' intermediate [ppb][h][ow] (float32)."""
  return 4 * (-(-ppb * h * w // 4) * 4 + ppb * h * ow)


@functools.lru_cache(maxsize=256)
def plane_plan(p: int, h: int, w: int, oh: int, ow: int) -> int:
  """Planes a block of the whole-plane kernel for P = p planes of h x w
  in and oh x ow out: the most that keep a block to PLANE_OUTPUTS outputs
  and PLANE_SMEM bytes and the launch to PLANE_MIN_BLOCKS blocks where p
  allows, at least 1; 0 (the tile kernel) where one plane takes more than
  SMEM_NO_OPT_IN."""
  if plane_smem(1, h, w, ow) > SMEM_NO_OPT_IN:
    return 0
  ppb = min(PLANE_OUTPUTS // (oh * ow), -(-p // PLANE_MIN_BLOCKS))
  while ppb > 1 and plane_smem(ppb, h, w, ow) > PLANE_SMEM:
    ppb -= 1
  return max(ppb, 1)


def out_size(n: int, k: int, up: int, down: int, pad) -> int:
  return (n * up + pad[0] + pad[1] - k) // down + 1


def upfirdn2d_plain(x, kernel, up: int = 1, down: int = 1, pad=(0, 0)):
  """Plain tensor ops in the order of `upfirdn2d_native`, on NCHW x with
  the same up, down and (pad0, pad1) on both axes: zero-insertion, pad or
  crop, depthwise correlation with the flipped kernel, decimation."""
  b, c, h, w = x.shape
  k = torch.as_tensor(np.asarray(kernel, np.float32), device=x.device,
                      dtype=x.dtype)
  kh, kw = k.shape
  p0, p1 = pad
  out = x.reshape(b, c, h, 1, w, 1)
  out = F.pad(out, (0, up - 1, 0, 0, 0, up - 1))
  out = out.reshape(b, c, h * up, w * up)
  out = F.pad(out, (max(p0, 0), max(p1, 0), max(p0, 0), max(p1, 0)))
  out = out[:, :, max(-p0, 0): out.shape[2] - max(-p1, 0),
            max(-p0, 0): out.shape[3] - max(-p1, 0)]
  wk = torch.flip(k, (0, 1)).reshape(1, 1, kh, kw).repeat(c, 1, 1, 1)
  out = F.conv2d(out, wk, groups=c)
  return out[:, :, ::down, ::down]


def _kernel():
  global _fn
  if _fn is None:
    fn = build.load("upfirdn2d.cu").indm_upfirdn2d_fwd
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _fn = fn
  return _fn


def _check(x, k, up, down, pad):
  if x.dim() != 4:
    raise ValueError(f"upfirdn2d takes NCHW input, got {tuple(x.shape)}")
  if x.dtype != torch.float32:
    raise TypeError(f"the upfirdn2d kernel takes float32, got {x.dtype}")
  if not x.is_contiguous():
    raise ValueError("upfirdn2d needs a contiguous NCHW input")
  if up not in (1, 2) or down not in (1, 2):
    raise ValueError(f"the upfirdn2d kernel takes up and down in (1, 2), "
                     f"got up={up} down={down}")
  if min(pad) < 0:
    raise ValueError(f"the upfirdn2d kernel takes non-negative pads, got "
                     f"{tuple(pad)}")
  if k.ndim != 2 or max(k.shape) > MAX_TAPS:
    raise ValueError(f"the upfirdn2d kernel takes a 2-D kernel of at most "
                     f"{MAX_TAPS}x{MAX_TAPS} taps, got {k.shape}")
  if x.numel() >= 2 ** 31:
    raise ValueError(f"{x.numel()} values are too many for 32-bit indexing")


def adjoint_pads(n_in: int, n_out: int, k: int, up: int, down: int,
                 pad) -> tuple:
  """The pads of upfirdn2d's adjoint along one axis of n_in inputs and
  n_out outputs with k taps (StyleGAN2's `UpFirDn2d.forward`): (k - p0 -
  1, n_in up - n_out down + p0 - up + 1), with up and down swapped and the
  taps flipped. Its output has n_in values again."""
  return (k - pad[0] - 1, n_in * up - n_out * down + pad[0] - up + 1)


def _adjoint(shape, k: np.ndarray, up: int, down: int, pad) -> tuple:
  """The adjoint's pads for an NCHW input of `shape`; raises where the
  kernel cannot take them (different pads along the two axes, or a
  negative one)."""
  if k.ndim != 2 or len(shape) != 4:
    raise ValueError(f"upfirdn2d takes NCHW input and a 2-D kernel, got "
                     f"{tuple(shape)} and {k.shape}")
  kh, kw = k.shape
  h, w = shape[2:]
  ph = adjoint_pads(h, out_size(h, kh, up, down, pad), kh, up, down, pad)
  pw = adjoint_pads(w, out_size(w, kw, up, down, pad), kw, up, down, pad)
  if ph != pw or min(ph) < 0:
    raise ValueError(
        f"upfirdn2d of {tuple(shape)} with a {kh}x{kw} kernel, up={up} "
        f"down={down} pads {tuple(pad)} needs a gradient, and the kernel "
        f"cannot take its adjoint (pads {ph} and {pw})")
  return ph


def _launch(x, k: np.ndarray, up: int, down: int, pad):
  """One launch of the kernel on CUDA x (the plain version on a CPU
  tensor), into a fresh output; no autograd."""
  if x.device.type == "cpu":
    with torch.no_grad():
      return upfirdn2d_plain(x, k, up, down, pad)
  t = taps(k)
  _check(x, t.k, up, down, pad)
  b, c, h, w = x.shape
  kh, kw = t.k.shape
  oh, ow = out_size(h, kh, up, down, pad), out_size(w, kw, up, down, pad)
  if oh <= 0 or ow <= 0:
    raise ValueError(f"upfirdn2d of {tuple(x.shape)} with a {kh}x{kw} "
                     f"kernel and pads {tuple(pad)} has no output")
  y = torch.empty((b, c, oh, ow), device=x.device, dtype=x.dtype)
  ppb = plane_plan(b * c, h, w, oh, ow) if t.col is not None else 0
  vec_in = h * w % 4 == 0 and x.data_ptr() % 16 == 0
  vec_out = ow % 4 == 0 and y.data_ptr() % 16 == 0
  args = (x.data_ptr(), y.data_ptr(), b * c, h, w, oh, ow, *t.ptrs, kh, kw,
          up, down, pad[0], ppb, vec_in, vec_out)
  rc = build.launch(_kernel(), x, *args)
  if rc != 0:
    raise RuntimeError(f"upfirdn2d kernel launch failed with CUDA error {rc}")
  return y


def _forward(x, k: np.ndarray, up: int, down: int, pad):
  """`_launch`, counted in `launches` where it launched the kernel."""
  global launches
  y = _launch(x, k, up, down, pad)
  if y.device.type == "cuda":
    launches += 1
  return y


class Upfirdn2dFn(torch.autograd.Function):
  """upfirdn2d through the kernel, forward and backward (on a CPU tensor
  through the plain version, both ways). The backward is the kernel on the
  adjoint (`adjoint_pads`); the forward raises where the kernel cannot
  take the adjoint."""

  @staticmethod
  def forward(ctx, x, kernel, up, down, pad):
    k = taps(kernel).k
    ctx.adjoint = (np.ascontiguousarray(k[::-1, ::-1]), down, up,
                   _adjoint(x.shape, k, up, down, pad))
    return _forward(x, k, up, down, pad)

  @staticmethod
  @torch.autograd.function.once_differentiable
  def backward(ctx, dy):
    global bwd_launches
    dx = _launch(dy.contiguous(), *ctx.adjoint)
    if dx.device.type == "cuda":
      bwd_launches += 1
    return dx, None, None, None, None


def upfirdn2d(x, kernel, up: int = 1, down: int = 1, pad=(0, 0)):
  """Upsample by zero insertion, pad by (pad0, pad1), convolve with the
  2-D FIR `kernel` (host array), downsample; NCHW, the same on both axes.

  A CPU tensor takes the plain version (differentiable by autograd); a
  CUDA tensor launches the kernel on the current stream, through
  `Upfirdn2dFn` (whose backward launches it on the adjoint) where x needs
  a gradient, and raises on any input it does not take."""
  if x.device.type == "cpu":
    return upfirdn2d_plain(x, kernel, up, down, pad)
  if x.device.type != "cuda":
    raise ValueError(f"upfirdn2d runs on cpu or cuda, not {x.device}")
  if x.requires_grad and torch.is_grad_enabled():
    return Upfirdn2dFn.apply(x, kernel, up, down, tuple(pad))
  return _forward(x, taps(kernel).k, up, down, tuple(pad))


@functools.lru_cache(maxsize=64)
def _fir_of(k, factor: int, scale: float) -> np.ndarray:
  return setup_kernel([1] * factor if k is None else k) * scale


def _fir(k, factor: int, scale: float) -> np.ndarray:
  """setup_kernel(k, or [1] * factor) * scale; built once for each
  distinct (k, factor, scale) where k is None or a tuple (the layers'
  `fir_kernel`), so that a call rebuilds no taps."""
  if k is None or isinstance(k, tuple):
    return _fir_of(k, factor, scale)
  return setup_kernel(k) * scale


def _resample(x, k, up=1, down=1, pad=(0, 0)):
  """upfirdn2d for the FIR resampling. A bfloat16 x (the VE net's res
  blocks under `model.mixed_precision`) is rounded into and out of the
  float32 computation: x to float32 (exact), the taps rounded to bfloat16
  as the JAX package casts them to x's type
  (`indm_tpu/ops/upfirdn2d.py:76-90`; exact for the configs'
  (1, 3, 3, 1)), the float32 sums rounded once to bfloat16. XLA's
  bfloat16 conv sums the same products in float32 and rounds once, so
  kernel 9 keeps its one float32 body on the card instead of a bfloat16
  mode (the sums in another order, as in float32); its backward, in
  autograd through the two casts, is the kernel on the adjoint in float32
  with the gradient rounded to bfloat16, as XLA's transposed conv rounds
  it."""
  if x.dtype == torch.bfloat16:
    k = torch.from_numpy(np.asarray(k, np.float32)).to(x.dtype).float()
    return upfirdn2d(x.float(), k.numpy(), up=up, down=down,
                     pad=pad).to(x.dtype)
  return upfirdn2d(x, k, up=up, down=down, pad=pad)


def upsample_2d(x, k=None, factor: int = 2, gain: float = 1.0):
  """FIR upsampling by `factor` (`indm_tpu/ops/upfirdn2d.py:upsample_2d`)."""
  k = _fir(k, factor, gain * factor ** 2)
  p = k.shape[0] - factor
  return _resample(x, k, up=factor, pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample_2d(x, k=None, factor: int = 2, gain: float = 1.0):
  """FIR downsampling by `factor`."""
  k = _fir(k, factor, gain)
  p = k.shape[0] - factor
  return _resample(x, k, down=factor, pad=((p + 1) // 2, p // 2))


def upsample_conv_2d(x, w, k=None, factor: int = 2, gain: float = 1.0):
  """Transposed conv by `factor` with the OIHW weight w, then the FIR.

  The transposed conv is the JAX package's dilated conv
  (`indm_tpu/ops/upfirdn2d.py:163-174`): zeros inserted between the input
  pixels, padding conv_size - 1, a correlation with the weight as it is
  (neither flipped nor its channels swapped).
  That is the intended StyleGAN2 semantics, not the reference torch code,
  which passes its stride as a 4-list and would raise."""
  conv = w.shape[-1]
  assert w.dim() == 4 and w.shape[-2] == conv
  k = _fir(k, factor, gain * factor ** 2)
  p = (k.shape[0] - factor) - (conv - 1)
  b, c, h, wd = x.shape
  xd = x.new_zeros((b, c, (h - 1) * factor + 1, (wd - 1) * factor + 1))
  xd[:, :, ::factor, ::factor] = x
  x = F.conv2d(xd, w, padding=conv - 1)
  return upfirdn2d(x, k, pad=((p + 1) // 2 + factor - 1, p // 2 + 1))


def conv_downsample_2d(x, w, k=None, factor: int = 2, gain: float = 1.0):
  """The FIR with pads for a strided conv, then the conv with the OIHW
  weight w at stride `factor`."""
  conv = w.shape[-1]
  assert w.shape[-2] == conv
  k = _fir(k, factor, gain)
  p = (k.shape[0] - factor) + (conv - 1)
  x = upfirdn2d(x, k, pad=((p + 1) // 2, p // 2))
  return F.conv2d(x, w, stride=factor)
