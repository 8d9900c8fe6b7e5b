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

Both chains run in float32 or in bfloat16, the TPU kernels' mode under
`flow.logdet_bf16` or `flow.mixed_precision` (`compute_dtype =
vareps.dtype`, `neumann_pallas.py:196, 359`): the mode is the type of the
inputs, which are all of one type, and acc is float32 in either. The plain
versions spell out the bfloat16 rounding points; on float64 inputs with
`compute_dtype=torch.bfloat16` they keep those points and compute every
other sum exactly (the card's reference).

In float32 both kernels split W1^T (kernel 8 also W1) once a call into
TF32 hi and lo planes, in scratch the wrapper allocates (`chain_plane_floats`,
`fused_scratch_bytes`), and run every 512-wide product on the `wgmma`
GEMM of `csrc/lipnet_wgmma.cuh`.

`launches` and `bf16_launches` count the calls of `neumann_chain` that
launched the kernel in float32 and in bfloat16 (one call runs
3 * (n + offset) CUDA launches, and the split in float32);
`fused_launches` and `fused_bf16_launches` those of `fused_neumann_chain`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from indm_torch.ops.lipnet_gemm import padded_k

# the image channels kernel 7 takes in either type: CIFAR-10's two flow
# scales (3, 12) and CelebA's (12, 48, after the flow's squeeze); kernel 8
# takes 3 and 12, the blocks the JAX package's `fused_chain_ok` sends it
# (in_ch < 33 <= width: a 48-channel block takes kernel 7)
CHANNELS = (3, 12, 48)
NARROW_CHANNELS = (3, 12)

DTYPES = (torch.float32, torch.bfloat16)

launches = 0
bf16_launches = 0
fused_launches = 0
fused_bf16_launches = 0

_fns = {}


def reset_launches():
  global launches, bf16_launches, fused_launches, fused_bf16_launches
  launches = bf16_launches = fused_launches = fused_bf16_launches = 0


def _held(ts):
  """The plain versions' working copies: bfloat16 held in float32, float32
  and float64 as they are; None stays None."""
  return [None if t is None else
          t.float() if t.dtype == torch.bfloat16 else t for t in ts]


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


def neumann_chain_plain(vareps, dacts, weights_t, n: int, offset: int, table,
                        compute_dtype=None):
  """acc = sum_{k=1}^{n+offset} (-1)^k coeff(k) (J^T)^k vareps with plain
  tensor ops: the arithmetic of `neumann_chain_ref`, NCHW, in the mode
  `compute_dtype` (default: the type of vareps).

  In bfloat16 the values are those of the Pallas body
  (`neumann_pallas.py:216-230`) held in float32: each conv's float32 sum
  rounded to bfloat16, each diagonal product rounded, and acc +=
  (-1)^k coeff(k) v in float32. acc is float32 (float64 on float64
  inputs)."""
  from indm_torch.ops.fused_block import rounder  # fused_block imports this
  r = rounder(vareps.dtype if compute_dtype is None else compute_dtype)
  v, *rest = _held([vareps, *dacts, *weights_t])
  dacts, weights_t = rest[:len(dacts)], rest[len(dacts):]
  acc = torch.zeros_like(v)
  for c in chain_coeffs(n, offset, table):
    for i, w in enumerate(weights_t):
      v = r(F.conv2d(v, w, padding=w.shape[-1] // 2))
      if i < len(dacts):
        v = r(v * dacts[i])
    acc = acc + float(c) * v
  return acc


def chain_plane_floats(idim):
  """Kernel 7's float32 scratch for W1^T's TF32 hi and lo planes
  (`lipnet::split_floats(I, I)`): 2*I*I8 floats, I8 = I rounded up to a
  multiple of 8."""
  return 2 * idim * padded_k(idim)


def _kernel(name):
  """The entry point `name` of neumann_chain.cu (float32, or bfloat16
  without the planes) or fused_chain.cu, built at first use."""
  fn = _fns.get(name)
  if fn is None:
    from indm_torch.ops import build
    p, i = ctypes.c_void_p, ctypes.c_int
    coeffs = ctypes.POINTER(ctypes.c_float)
    if name == "indm_fused_neumann_chain":
      fn = build.load("fused_chain.cu").indm_fused_neumann_chain
      fn.argtypes = ([p] * 10 + [coeffs, i, i, i, p, p, ctypes.c_int64]
                     + [i] * 5 + [p])
    else:
      # the float32 entry point takes W1^T's planes after t2
      fn = getattr(build.load("neumann_chain.cu"), name)
      scratch = 4 if name == "indm_neumann_chain_bf16" else 5
      fn.argtypes = [p] * 7 + [coeffs, i] + [p] * scratch + [i] * 5 + [p]
    fn.restype = ctypes.c_int
    _fns[name] = fn
  return fn


def _check_types(bad, device, named, dtype):
  """Every tensor of `named` ((name, tensor, shape)) of that shape, of the
  kernels' type `dtype` (float32 or bfloat16), contiguous, 16-byte aligned
  and on `device`."""
  if dtype not in DTYPES:
    bad(f"the kernel computes in float32 or bfloat16, not {dtype}")
  for name, t, shape in named:
    if tuple(t.shape) != shape:
      bad(f"{name}: expected {shape}, got {tuple(t.shape)}")
    if (t.dtype != dtype or not t.is_contiguous() or t.device != device
        or t.data_ptr() % 16):
      bad(f"{name} must be a contiguous, 16-byte aligned {dtype} tensor on "
          f"{device}, as every input")


def _check_geometry(bad, b, c, h, w, idim, dtype, fused=False):
  """Channels 3, 12 or 48 (kernel 7), 3 or 12 (kernel 8, `fused`); H*W
  and the width multiples of 4 in float32 and of 8 in bfloat16 (a 16-byte
  copy of the GEMM holds 8); 32-bit indexing."""
  align = 4 if dtype == torch.float32 else 8
  channels = NARROW_CHANNELS if fused else CHANNELS
  if c not in channels:
    if c in CHANNELS:  # 48 under INDM_FUSED_CHAIN=1
      bad(f"INDM_FUSED_CHAIN=1 is built for {NARROW_CHANNELS} channels, got "
          f"{c}: at {c} channels (CelebA's second flow scale) the JAX "
          "package's fused_chain_ok sends the block to kernel 7, as the "
          "flow does")
    bad(f"the kernel is built for {channels} channels, got {c}")
  if (h * w) % align or idim % align:
    bad(f"H*W ({h * w}) and the width ({idim}) must be multiples of {align} "
        f"in {dtype}")
  if b * idim * h * w >= 2 ** 31:
    bad("the kernel indexes one sample with 32-bit ints")


def _check(vareps, dacts, weights_t):
  def bad(msg):
    raise ValueError(f"neumann_chain: {msg}")

  if vareps.dim() != 4:
    bad(f"vareps must be NCHW, got {tuple(vareps.shape)}")
  b, c, h, w = vareps.shape
  if len(weights_t) != 3 or len(dacts) not in (2, 3):
    bad("needs three transposed weights and two or three diagonals")
  idim = weights_t[0].shape[0]
  _check_geometry(bad, b, c, h, w, idim, vareps.dtype)
  want_w = [(idim, c, 3, 3), (idim, idim, 1, 1), (c, idim, 3, 3)]
  want_d = [(b, idim, h, w), (b, idim, h, w), (b, c, h, w)][:len(dacts)]
  _check_types(bad, vareps.device,
               [("vareps", vareps, (b, c, h, w))]
               + [("weights_t", t, s) for t, s in zip(weights_t, want_w)]
               + [("dacts", t, s) for t, s in zip(dacts, want_d)],
               vareps.dtype)


def neumann_chain(vareps, dacts, weights_t, n: int, offset: int, table):
  """The chain's acc [B, C, H, W] float32 (the caller adds vareps for u),
  in the mode of the inputs' type, float32 or bfloat16.

  A CPU tensor takes the plain version; a CUDA tensor launches the kernel
  on the current stream (and raises on any input it does not take)."""
  global launches, bf16_launches
  if vareps.device.type == "cpu":
    return neumann_chain_plain(vareps, dacts, weights_t, n, offset, table)
  if vareps.device.type != "cuda":
    raise ValueError(f"neumann_chain runs on cpu or cuda, not "
                     f"{vareps.device}")
  _check(vareps, dacts, weights_t)
  b, c, h, w = vareps.shape
  idim = weights_t[0].shape[0]
  bf16 = vareps.dtype == torch.bfloat16
  coeffs = chain_coeffs(int(n), int(offset), table)
  acc = torch.empty_like(vareps, dtype=torch.float32)
  v = torch.empty_like(vareps)
  t1 = torch.empty((b, idim, h, w), device=vareps.device, dtype=vareps.dtype)
  t2 = torch.empty_like(t1)
  scratch = [v, t1, t2]
  if not bf16:  # W1^T's planes
    scratch.append(torch.empty(chain_plane_floats(idim), dtype=torch.float32,
                               device=vareps.device))
  d_in = dacts[2].data_ptr() if len(dacts) == 3 else None
  fn = _kernel("indm_neumann_chain_bf16" if bf16 else "indm_neumann_chain")
  with torch.cuda.device(vareps.device):
    stream = torch.cuda.current_stream(vareps.device).cuda_stream
    rc = fn(vareps.data_ptr(), dacts[0].data_ptr(), dacts[1].data_ptr(),
            d_in, weights_t[0].data_ptr(), weights_t[1].data_ptr(),
            weights_t[2].data_ptr(),
            coeffs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(coeffs), acc.data_ptr(), *(t.data_ptr() for t in scratch),
            b, c, h, w, idim, stream)
  if rc != 0:
    raise RuntimeError(f"neumann_chain kernel launch failed with CUDA error "
                       f"{rc}")
  if bf16:
    bf16_launches += 1
  else:
    launches += 1
  return acc


# ---- the fully fused chain (INDM_FUSED_CHAIN=1) ----


def fused_chain_inputs(block, h, dtype=torch.float32):
  """(fwd_mats, biases, weights_t, hp) of an iResBlock for
  `fused_neumann_chain` in `dtype`: the forward weights W0 [I, C, 3, 3] and
  W1 [I, I], the biases b0 and b1, the transposed weights in
  `neumann_chain`'s layout (W2^T, W1^T, W0^T; `transpose_conv_weight`) and
  hp [B, I] or None, every weight normalised by
  `LopConv2d.normalized_weight` as the net's forward normalises it. In
  bfloat16 (`neumann_pallas.py:298-332` with dtype=bfloat16) the weights
  and biases are cast after the normalisation and hp is a bfloat16
  product, h @ h_w + h_b with each step rounded
  (`IResBlock.h_projection`). Run it under no_grad."""
  w0, w1, w2 = (c.normalized_weight().to(dtype) for c in block.convs())
  b0, b1 = (c.bias.to(dtype) for c in block.convs()[:2])
  weights_t = [transpose_conv_weight(w).contiguous() for w in (w2, w1, w0)]
  return ((w0, w1[:, :, 0, 0]), (b0, b1), weights_t,
          block.h_projection(h, dtype))


def fused_neumann_chain_plain(x, vareps, fwd_mats, biases, weights_t, hp,
                              n: int, offset: int, table, preact: bool,
                              compute_dtype=None):
  """The chain's acc with the diagonals made from x in plain tensor ops:
  the arithmetic of the Pallas body (`neumann_pallas.py:366-420`), NCHW,
  in the mode `compute_dtype` (default: the type of x).
  d0 = cos 2 pi x and s = sin_act(x) if preact, else s = x; z1 = W0 s + b0,
  d1 = cos 2 pi z1, s1 = sin_act(z1) + hp; z2 = W1 s1 + b1,
  d2 = cos 2 pi z2; then `neumann_chain_plain` on [d2, d1, (d0)].

  In bfloat16 (`neumann_pallas.py:381-404`) each product's float32 sum is
  rounded, then the bias added in bfloat16; sin and cos are taken in
  float32 of the rounded z and rounded; s1 + hp is added in bfloat16; the
  chain rounds as `neumann_chain_plain` does. These are the forward
  layers of kernel 3 in that mode (`fused_block._forward_layers`)."""
  from indm_torch.ops import fused_block as fb
  cdt = x.dtype if compute_dtype is None else compute_dtype
  r = fb.rounder(cdt)
  x, vareps, w0, w1, b0, b1, hp = _held([x, vareps, *fwd_mats, *biases, hp])
  _, d0, _, _, d1, _, d2 = fb._forward_layers(
      r(x), w0, w1[:, :, None, None], b0, b1, hp, preact, r)
  dacts = [d2, d1] + ([d0] if preact else [])
  return neumann_chain_plain(r(vareps), dacts, weights_t, n, offset, table,
                             cdt)


def fused_scratch_bytes(b, c, hw, idim, dtype):
  """Kernel 8's scratch, s1, d1, d2, t2 [B, I, H, W] and s0, d0, v
  [B, C, H, W] in the compute type, and in float32 W1's and W1^T's planes
  in front (2 * `chain_plane_floats`): `indm_fused_chain_scratch_bytes` of
  `csrc/fused_chain.cu`."""
  if dtype == torch.bfloat16:
    return 2 * (4 * b * idim * hw + 3 * b * c * hw)
  return 4 * (2 * chain_plane_floats(idim) + 4 * b * idim * hw
              + 3 * b * c * hw)


def _check_fused(x, vareps, fwd_mats, biases, weights_t, hp):
  def bad(msg):
    raise ValueError(f"fused_neumann_chain: {msg}")

  if x.dim() != 4:
    bad(f"x must be NCHW, got {tuple(x.shape)}")
  b, c, h, w = x.shape
  if len(fwd_mats) != 2 or len(biases) != 2 or len(weights_t) != 3:
    bad("needs two forward weights, two biases and three transposed "
        "weights")
  idim = fwd_mats[0].shape[0]
  _check_geometry(bad, b, c, h, w, idim, x.dtype, fused=True)
  want = [("x", x, (b, c, h, w)), ("vareps", vareps, (b, c, h, w)),
          ("w0", fwd_mats[0], (idim, c, 3, 3)),
          ("w1", fwd_mats[1], (idim, idim)), ("b0", biases[0], (idim,)),
          ("b1", biases[1], (idim,)),
          ("w2t", weights_t[0], (idim, c, 3, 3)),
          ("w1t", weights_t[1], (idim, idim, 1, 1)),
          ("w0t", weights_t[2], (c, idim, 3, 3))]
  if hp is not None:
    want.append(("hp", hp, (b, idim)))
  _check_types(bad, x.device, want, x.dtype)


def fused_neumann_chain(x, vareps, fwd_mats, biases, weights_t, hp, n: int,
                        offset: int, table, preact: bool):
  """The chain's acc [B, C, H, W] float32 for the block input x (the
  caller adds vareps for u), in the mode of the inputs' type, float32 or
  bfloat16. A CPU tensor takes the plain version; a CUDA tensor launches
  the kernel on the current stream (and raises on any input it does not
  take)."""
  global fused_launches, fused_bf16_launches
  if x.device.type == "cpu":
    return fused_neumann_chain_plain(x, vareps, fwd_mats, biases, weights_t,
                                     hp, n, offset, table, preact)
  if x.device.type != "cuda":
    raise ValueError(f"fused_neumann_chain runs on cpu or cuda, not "
                     f"{x.device}")
  _check_fused(x, vareps, fwd_mats, biases, weights_t, hp)
  b, c, h, w = x.shape
  idim = fwd_mats[0].shape[0]
  bf16 = x.dtype == torch.bfloat16
  coeffs = chain_coeffs(int(n), int(offset), table)
  acc = torch.empty_like(x, dtype=torch.float32)
  scratch = torch.empty(fused_scratch_bytes(b, c, h * w, idim, x.dtype),
                        dtype=torch.uint8, device=x.device)
  fn = _kernel("indm_fused_neumann_chain")
  with torch.cuda.device(x.device):
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), vareps.data_ptr(), fwd_mats[0].data_ptr(),
            fwd_mats[1].data_ptr(), biases[0].data_ptr(),
            biases[1].data_ptr(), None if hp is None else hp.data_ptr(),
            weights_t[0].data_ptr(), weights_t[1].data_ptr(),
            weights_t[2].data_ptr(),
            coeffs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(coeffs), int(preact), int(bf16), acc.data_ptr(),
            scratch.data_ptr(), scratch.numel(), b, c, h, w, idim, stream)
  if rc != 0:
    raise RuntimeError(f"fused_neumann_chain kernel launch failed with CUDA "
                       f"error {rc}")
  if bf16:
    fused_bf16_launches += 1
  else:
    fused_launches += 1
  return acc
