"""The Lipschitz net's 512-wide product alone: the two Hopper GEMMs and
their plain version.

Counterpart of the products the TPU kernels make in VMEM:
`_apply_packed(x, w, "mat")` (`indm_tpu/ops/neumann_pallas.py:74-76`, the
1x1 conv of a [pixels, channels] tile) and `_wgrad(a, b)`
(`indm_tpu/ops/fused_block.py:165-168`, a weight gradient contracted over
the pixels). In the port's NCHW layout both are per-sample products over
one or two pairs (a, b):

  out[s] = sum_p a_p[s] @ b_p[s]       bt=False: a [M, K], b [K, N]
  out[s] = sum_p a_p[s] @ b_p[s]^T     bt=True:  a [M, K], b [N, K]

An operand of three dimensions has the batch first; one of two is shared
by every sample (a weight). Both pairs have the same shapes.

`lipnet_gemm` is the wrapper: on a CUDA tensor it launches the tensor-core
GEMM of `indm_torch/csrc/lipnet_ops.cuh` (3xTF32 `mma.sync` with float32
accumulation, a `cp.async` ring; its note has the design and the bound)
through the entry point `csrc/lipnet_gemm.cu`, or raises; on a CPU tensor
it computes `lipnet_gemm_plain`. The float32 backwards (kernels 4 and 6)
launch the same device code from their own sources, so the main path never
calls this module's kernels: it exists to test and time the GEMM alone.
`launches` counts the calls that launched the kernel.

`lipnet_wgmma` is the second route, the GEMM of every float32 product
with a weight fixed for the call (the forwards of kernels 3 and 5, the
chains of kernels 7 and 8, kernel 8's layer 1): out[s] = w @ act[s] for
one weight w [M, K] shared by the samples of act [B, K, N]. On a CUDA
tensor it launches `indm_torch/csrc/lipnet_wgmma.cuh`'s `wgmma` kernel
through the entry point `indm_lipnet_wgmma` of `csrc/lipnet_gemm.cu` (the
weight split once a call into the TF32 planes of `weight_planes_plain`,
then the product: 3xTF32 with the activations as the register operand;
its note has the design and the bound), or raises; on a CPU tensor it
computes `lipnet_gemm_plain`. `wgmma_launches` counts its launches.

`lipnet_gemm_bf16` is the third route, the product of the bfloat16 mode
of kernels 3-8: the same pairs (one to three) with bfloat16 operands and a
float32 output. On a CUDA tensor it launches `lipnet_wgmma_bf16.cuh`'s
`wgmma_bf16_kernel` (`wgmma` with both operands through TMA, float32
sums; its note has the design and the bound) through the entry point
`indm_lipnet_gemm_bf16`, or raises; on a CPU tensor it computes
`lipnet_gemm_bf16_plain`.
`bf16_launches` counts its launches.

`device_gemm_launches` sums the launches of the three GEMMs that every
loaded library of the port has counted on the host where it launches them,
inside the flow kernels too: a run's launches without a profiler.
"""

from __future__ import annotations

import ctypes

import torch

MAX_BATCH = 65535  # gridDim.z

launches = 0
wgmma_launches = 0
bf16_launches = 0

_fn = None
_wgmma_fn = None
_bf16_fn = None


def reset_launches():
  global launches, wgmma_launches, bf16_launches
  launches = wgmma_launches = bf16_launches = 0


def lipnet_gemm_plain(pairs, bt=False):
  """The products in float32 `torch.matmul` (TF32 off, PyTorch's default
  for matmuls), summed over the pairs in order."""
  out = None
  for a, b in pairs:
    y = torch.matmul(a, b.transpose(-1, -2) if bt else b)
    out = y if out is None else out + y
  return out


def _kernel():
  global _fn
  if _fn is None:
    from indm_torch.ops import build
    fn = build.load("lipnet_gemm.cu").indm_lipnet_gemm
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int64,
                                            ctypes.c_int64, ctypes.c_int,
                                            ctypes.c_void_p]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _fn = fn
  return _fn


def _check(pairs, bt, dtype=torch.float32, max_pairs=2, align=4,
           what="lipnet_gemm"):
  """(batch, M, N, K) of the product; raises ValueError on what the kernel
  does not take, on any device, so that the CPU refuses what the card
  refuses: up to `max_pairs` pairs of `dtype`, K and N multiples of
  `align`."""
  def bad(msg):
    raise ValueError(f"{what}: {msg}")

  pairs = list(pairs)
  if not 1 <= len(pairs) <= max_pairs:
    bad(f"one to {max_pairs} (a, b) pairs, got {len(pairs)}")
  a, b = pairs[0]
  for p, (ap, bp) in enumerate(pairs):
    for name, t in (("a", ap), ("b", bp)):
      if (t.dtype != dtype or not t.is_contiguous()
          or t.device != a.device or t.dim() not in (2, 3)):
        bad(f"{name}{p} must be a contiguous {dtype} tensor of 2 or 3 "
            f"dimensions on {a.device}, got {t.dtype} {tuple(t.shape)}")
    if ap.shape != a.shape or bp.shape != b.shape:
      bad("both pairs must have the same shapes")
  if a.dim() == 2 and b.dim() == 2:
    bad("one operand needs the batch dimension")
  m, k = a.shape[-2:]
  if bt:
    n, kb = b.shape[-2:]
  else:
    kb, n = b.shape[-2:]
  if kb != k:
    bad(f"a {tuple(a.shape)} and b {tuple(b.shape)} do not contract "
        f"(bt={bt})")
  if k % align or n % align:
    bad(f"K and N must be multiples of {align}, got K={k}, N={n}")
  batches = {t.shape[0] for t in (a, b) if t.dim() == 3}
  if len(batches) != 1:
    bad(f"a and b disagree on the batch: {sorted(batches)}")
  batch = batches.pop()
  if not 0 < batch <= MAX_BATCH:
    bad(f"the batch must be in [1, {MAX_BATCH}], got {batch}")
  return batch, m, n, k


def lipnet_gemm(pairs, bt=False):
  """out [batch, M, N] = sum over the pairs (a, b) of a @ b (bt=False) or
  a @ b^T (bt=True), per sample. A CPU tensor takes the plain version; a
  CUDA tensor launches the kernel on the current stream (and raises on
  any input it does not take)."""
  global launches
  pairs = list(pairs)
  batch, m, n, k = _check(pairs, bt)
  a = pairs[0][0]
  if a.device.type == "cpu":
    return lipnet_gemm_plain(pairs, bt)
  if a.device.type != "cuda":
    raise ValueError(f"lipnet_gemm runs on cpu or cuda, not {a.device}")
  for p, (ap, bp) in enumerate(pairs):
    for name, t in (("a", ap), ("b", bp)):
      if t.data_ptr() % 16:
        raise ValueError(f"lipnet_gemm: {name}{p} must start on a 16-byte "
                         "boundary")
  out = torch.empty((batch, m, n), dtype=torch.float32, device=a.device)
  (a0, b0), (a1, b1) = pairs[0], pairs[-1]
  a_bs = m * k if a0.dim() == 3 else 0
  b_bs = n * k if b0.dim() == 3 else 0
  fn = _kernel()
  with torch.cuda.device(a.device):
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = fn(a0.data_ptr(), b0.data_ptr(), a1.data_ptr(), b1.data_ptr(),
            len(pairs), a_bs, b_bs, int(bt), out.data_ptr(), batch, m, n, k,
            stream)
  if rc != 0:
    raise RuntimeError(f"lipnet_gemm kernel launch failed with CUDA error "
                       f"{rc}")
  launches += 1
  return out


def tf32(x):
  """x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero,
  as `lipnet::rna_tf32` rounds: half of the dropped 13 bits added to the
  magnitude, then cleared (float32 in and out)."""
  u = x.contiguous().view(torch.int32)
  return ((u + 0x1000) & -0x2000).view(torch.float32)


def padded_k(k):
  """K rounded up to a multiple of 8: the planes' row length."""
  return -(-k // 8) * 8


def k_order(k):
  """The weight's k index at each column of a plane row: within each group
  of 8, column t holds k = 2t and column t + 4 holds k = 2t + 1 (t < 4), so
  that the activation rows a thread reads for its fragment are 2t and
  2t + 1 (the note of `csrc/lipnet_wgmma.cuh`); -1 past K."""
  j = torch.arange(padded_k(k))
  t = j % 8
  src = j - t + torch.where(t < 4, 2 * t, 2 * t - 7)
  return torch.where(src < k, src, torch.full_like(src, -1))


def weight_planes_plain(w):
  """The planes [2, M, K8] that the wgmma route makes of w [M, K] once a
  call (`lipnet::split_planes_kernel`): hi = tf32(w), lo = tf32(w - hi),
  the columns in `k_order`, zero past K."""
  m, k = w.shape
  src = k_order(k)
  x = torch.zeros((m, src.numel()), dtype=torch.float32, device=w.device)
  x[:, src >= 0] = w[:, src[src >= 0]]
  hi = tf32(x)
  return torch.stack([hi, tf32(x - hi)])


def _wgmma_kernel():
  global _wgmma_fn
  if _wgmma_fn is None:
    from indm_torch.ops import build
    fn = build.load("lipnet_gemm.cu").indm_lipnet_wgmma
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _wgmma_fn = fn
  return _wgmma_fn


def _check_wgmma(w, act):
  """(batch, M, N, K) of w @ act[s]; raises ValueError on what the kernel
  does not take, on any device."""
  def bad(msg):
    raise ValueError(f"lipnet_wgmma: {msg}")

  for name, t, dim in (("w", w, 2), ("act", act, 3)):
    if (t.dtype != torch.float32 or not t.is_contiguous()
        or t.device != act.device or t.dim() != dim):
      bad(f"{name} must be a contiguous float32 tensor of {dim} dimensions "
          f"on {act.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
  m, k = w.shape
  batch, ka, n = act.shape
  if ka != k:
    bad(f"w {tuple(w.shape)} and act {tuple(act.shape)} do not contract")
  if k % 4 or n % 4:
    bad(f"K and N must be multiples of 4, got K={k}, N={n}")
  if min(batch, m, n, k) < 1:
    bad(f"empty product {tuple(w.shape)} @ {tuple(act.shape)}")
  return batch, m, n, k


def lipnet_wgmma(w, act):
  """out [batch, M, N] = w @ act[s] for each sample s, w [M, K] shared, act
  [batch, K, N]. A CPU tensor takes the plain version; a CUDA tensor
  launches the wgmma kernel on the current stream (and raises on any input
  it does not take)."""
  global wgmma_launches
  batch, m, n, k = _check_wgmma(w, act)
  if act.device.type == "cpu":
    return lipnet_gemm_plain([(w, act)])
  if act.device.type != "cuda":
    raise ValueError(f"lipnet_wgmma runs on cpu or cuda, not {act.device}")
  if act.data_ptr() % 16:
    raise ValueError("lipnet_wgmma: act must start on a 16-byte boundary")
  out = torch.empty((batch, m, n), dtype=torch.float32, device=act.device)
  planes = torch.empty(2 * m * padded_k(k), dtype=torch.float32,
                       device=act.device)
  fn = _wgmma_kernel()
  with torch.cuda.device(act.device):
    stream = torch.cuda.current_stream(act.device).cuda_stream
    rc = fn(w.data_ptr(), act.data_ptr(), out.data_ptr(), planes.data_ptr(),
            batch, m, n, k, stream)
  if rc != 0:
    raise RuntimeError(f"lipnet_wgmma kernel launch failed with CUDA error "
                       f"{rc}")
  wgmma_launches += 1
  return out


# the sources whose libraries launch the net's GEMMs
GEMM_SOURCES = ("fused_block.cu", "fused_stack.cu", "neumann_chain.cu",
                "fused_chain.cu", "lipnet_gemm.cu")


def device_gemm_launches():
  """{"gemm_3xtf32": n, "wgmma": n, "gemm_bf16": n}: the launches of
  `gemm_3xtf32_kernel`, `wgmma_3xtf32_kernel` and `wgmma_bf16_kernel` that
  the loaded libraries of GEMM_SOURCES have counted (each where it
  launches the kernel, entry point `indm_gemm_launches`) since they were
  loaded. Builds nothing."""
  from indm_torch.ops import build
  out = {"gemm_3xtf32": 0, "wgmma": 0, "gemm_bf16": 0}
  for source in GEMM_SOURCES:
    lib = build.loaded(source)
    if lib is not None:
      fn = lib.indm_gemm_launches
      fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int64
      for which, name in enumerate(out):
        out[name] += fn(which)
  return out


def device_conv_launches(source):
  """{"conv_in": n, "conv_out": n}: the launches of `lipnet::conv_in_kernel`
  and `conv_out_kernel` that the loaded library of `source` (a file of
  GEMM_SOURCES) has counted where it launches them (entry point
  `indm_conv_launches`) since it was loaded; zeros if it is not loaded.
  Builds nothing."""
  from indm_torch.ops import build
  out = {"conv_in": 0, "conv_out": 0}
  lib = build.loaded(source)
  if lib is not None:
    fn = lib.indm_conv_launches
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int64
    for which, name in enumerate(out):
      out[name] = fn(which)
  return out


def lipnet_gemm_bf16_plain(pairs, bt=False):
  """The bfloat16 products in float32 `torch.matmul` (exact products of
  bfloat16 values, float32 sums), summed over the pairs in order."""
  return lipnet_gemm_plain([(a.float(), b.float()) for a, b in pairs], bt)


def _bf16_kernel():
  global _bf16_fn
  if _bf16_fn is None:
    from indm_torch.ops import build
    fn = build.load("lipnet_gemm.cu").indm_lipnet_gemm_bf16
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_int64,
                                            ctypes.c_int64, ctypes.c_int,
                                            ctypes.c_void_p]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _bf16_fn = fn
  return _bf16_fn


def lipnet_gemm_bf16(pairs, bt=False):
  """out [batch, M, N] float32 = sum over the one to three pairs (a, b) of
  bfloat16 operands of a @ b (bt=False) or a @ b^T (bt=True), per sample;
  K and N multiples of 8. A CPU tensor takes the
  plain version; a CUDA tensor launches the kernel on the current stream
  (and raises on any input it does not take)."""
  global bf16_launches
  pairs = list(pairs)
  batch, m, n, k = _check(pairs, bt, torch.bfloat16, 3, 8,
                          "lipnet_gemm_bf16")
  a = pairs[0][0]
  if a.device.type == "cpu":
    return lipnet_gemm_bf16_plain(pairs, bt)
  if a.device.type != "cuda":
    raise ValueError(f"lipnet_gemm_bf16 runs on cpu or cuda, not {a.device}")
  if any(t.data_ptr() % 16 for pair in pairs for t in pair):
    raise ValueError("lipnet_gemm_bf16: every operand must start on a "
                     "16-byte boundary")
  out = torch.empty((batch, m, n), dtype=torch.float32, device=a.device)
  ptrs = (ctypes.c_void_p * 3)(*[ap.data_ptr() for ap, _ in pairs])
  bptrs = (ctypes.c_void_p * 3)(*[bp.data_ptr() for _, bp in pairs])
  a_bs = m * k if a.dim() == 3 else 0
  b_bs = n * k if pairs[0][1].dim() == 3 else 0
  fn = _bf16_kernel()
  with torch.cuda.device(a.device):
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = fn(ptrs, bptrs, len(pairs), a_bs, b_bs, int(bt), out.data_ptr(),
            batch, m, n, k, stream)
  if rc != 0:
    raise RuntimeError(f"lipnet_gemm_bf16 kernel launch failed with CUDA "
                       f"error {rc}")
  bf16_launches += 1
  return out
