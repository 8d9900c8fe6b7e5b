"""A narrow-channel 3x3 SAME stride-1 conv: the Hopper kernel and its plain
version.

Counterpart of the Pallas case of the JAX package's narrow-conv benchmark
(`scripts/bench_narrow_conv.py:pallas_conv`, on the packed-tap arithmetic
of `indm_tpu/ops/neumann_pallas.py:_apply_packed`). `narrow_conv` is the
wrapper: on a CUDA tensor it launches the hand-written kernel of
`indm_torch/csrc/narrow_conv.cu` or raises; on a CPU tensor it computes
`narrow_conv_plain`. The kernel's design and its bound are in the source's
note.

Layout is NCHW with OIHW weights. One of the two channel counts is narrow
(3 or 12, the counts the Lipschitz net's device code is built for) and the
other wide (33 or more, a multiple of 4): "narrow_in" is C -> I,
"narrow_out" I -> C. x and w are float32 or bfloat16, of one type; the sums
are float32 and the output is rounded once to x's type, as
`.astype(x_ref.dtype)` in `pallas_conv`.

`launches` counts the calls of `narrow_conv` that launched the kernel.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

NARROW = (3, 12)
MIN_WIDE = 33
MAX_BATCH = 65535  # gridDim.z
DTYPES = (torch.float32, torch.bfloat16)

launches = 0

_fn = None


def reset_launches():
  global launches
  launches = 0


def narrow_conv_plain(x, w):
  """The packed-tap arithmetic in plain tensor ops, float32 sums, one
  rounding to x's type. narrow_in: the 9 shifted narrow views as im2col
  rows ([B, 9*C, H*W], F.unfold) times the [I, 9*C] weight. narrow_out:
  the [9*C, I] packed weight times the wide input, then the 9 taps'
  C-channel planes shifted and added."""
  b, cin, h, wd = x.shape
  cout = w.shape[0]
  xf, wf = x.float(), w.float()
  if cin < cout:  # narrow_in
    patches = F.unfold(xf, 3, padding=1)                 # [B, 9*C, H*W]
    y = torch.matmul(wf.reshape(cout, cin * 9), patches)
    return y.reshape(b, cout, h, wd).to(x.dtype)
  packed = wf.permute(2, 3, 0, 1).reshape(9 * cout, cin)  # (tap, c) rows
  z = torch.matmul(packed, xf.reshape(b, cin, h * wd))
  zp = F.pad(z.reshape(b, 9, cout, h, wd), (1, 1, 1, 1))
  y = None
  for dy in range(3):
    for dx in range(3):
      piece = zp[:, dy * 3 + dx, :, dy:dy + h, dx:dx + wd]
      y = piece if y is None else y + piece
  return y.to(x.dtype)


def _kernel():
  global _fn
  if _fn is None:
    from indm_torch.ops import build
    fn = build.load("narrow_conv.cu").indm_narrow_conv
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _fn = fn
  return _fn


def _check(x, w):
  def bad(msg):
    raise ValueError(f"narrow_conv: {msg}")

  if x.dim() != 4 or w.dim() != 4:
    bad(f"x must be NCHW and w OIHW, got {tuple(x.shape)} and "
        f"{tuple(w.shape)}")
  b, cin, h, wd = x.shape
  cout = w.shape[0]
  if tuple(w.shape) != (cout, cin, 3, 3):
    bad(f"w: expected ({cout}, {cin}, 3, 3), got {tuple(w.shape)}")
  narrow, wide = min(cin, cout), max(cin, cout)
  if narrow not in NARROW or wide < MIN_WIDE or wide % 4:
    bad(f"one channel count must be in {NARROW} and the other at least "
        f"{MIN_WIDE} and a multiple of 4, got {cin} -> {cout}")
  if b > MAX_BATCH:
    bad(f"the launch grid's z dimension holds the batch: at most "
        f"{MAX_BATCH}, got {b}")
  for name, t in (("x", x), ("w", w)):
    if (t.dtype not in DTYPES or t.dtype != x.dtype or not t.is_contiguous()
        or t.device != x.device):
      bad(f"{name} must be a contiguous float32 or bfloat16 tensor of x's "
          f"type on {x.device}")


def narrow_conv(x, w):
  """The conv's output [B, cout, H, W] in x's type. A CPU tensor takes the
  plain version; a CUDA tensor launches the kernel on the current stream
  (and raises on any input it does not take)."""
  global launches
  if x.device.type == "cpu":
    return narrow_conv_plain(x, w)
  if x.device.type != "cuda":
    raise ValueError(f"narrow_conv runs on cpu or cuda, not {x.device}")
  _check(x, w)
  b, cin, h, wd = x.shape
  cout = w.shape[0]
  out = torch.empty((b, cout, h, wd), dtype=x.dtype, device=x.device)
  fn = _kernel()
  with torch.cuda.device(x.device):
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), b, cin, cout, h, wd,
            int(x.dtype == torch.bfloat16), stream)
  if rc != 0:
    raise RuntimeError(f"narrow_conv kernel launch failed with CUDA error "
                       f"{rc}")
  launches += 1
  return out
