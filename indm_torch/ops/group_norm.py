"""GroupNorm (+ optional swish), forward and backward: the Hopper kernels
and their plain versions.

`group_norm_act` (forward) and `group_norm_act_backward` are the wrappers.
On a CUDA tensor they launch the hand-written kernels of
`indm_torch/csrc/group_norm.cu`, which replace the TPU kernels
`indm_tpu/ops/group_norm_pallas.py:_fwd_call` and `_bwd_call`, or raise;
on a CPU tensor they compute `group_norm_act_plain` and
`group_norm_act_backward_plain`. `GroupNormAct` is the
`torch.autograd.Function` the score net trains through: its forward is
`group_norm_act`, its backward `group_norm_act_backward`. The kernels'
design, their numerical contract and their bounds are in the source's note.

`launches` and `bwd_launches` count the calls of the two wrappers that
launched a kernel, so that a run can show that its path went through them.
"""

from __future__ import annotations

import ctypes

import torch

ACTS = ("none", "swish")

launches = 0
bwd_launches = 0

_fn = None
_bwd_fn = None


def reset_launches():
  global launches, bwd_launches
  launches = 0
  bwd_launches = 0


def group_norm_act_plain(x, scale, bias, num_groups: int, eps: float = 1e-6,
                         act: str = "none"):
  """Plain tensor ops with the kernel's contract, mirroring
  `group_norm_act_reference`: f32 statistics over each group of
  contiguous channels, variance E[x^2] - mean^2, optional swish, output in
  x's dtype. x is NCHW."""
  b, c, h, w = x.shape
  xf = x.float().reshape(b, num_groups, -1)
  mean = xf.mean(dim=-1, keepdim=True)
  var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
  y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, c, h, w)
  y = y * scale.float().reshape(1, c, 1, 1) + bias.float().reshape(1, c, 1, 1)
  if act == "swish":
    y = y * torch.sigmoid(y)
  return y.to(x.dtype)


def group_norm_act_backward_plain(x, dy, scale, bias, num_groups: int,
                                  eps: float = 1e-6, act: str = "none"):
  """(dx, dscale, dbias) of `group_norm_act_plain` with plain tensor ops,
  the arithmetic of the TPU backward kernel (`_bwd_kernel`): the
  statistics recomputed as the forward computes them, g = dy * swish'(u)
  under swish, dx = rstd * (g*scale - mean_grp(g*scale)
  - xhat * mean_grp(g*scale*xhat)), dscale = sum g*xhat and dbias = sum g
  over batch and pixels. dx in x's dtype, dscale and dbias float32."""
  b, c, h, w = x.shape
  xf = x.float().reshape(b, num_groups, -1)
  mean = xf.mean(dim=-1, keepdim=True)
  var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
  rstd = torch.rsqrt(var + eps)
  xhat = (xf - mean) * rstd
  s4 = scale.float().reshape(1, c, 1, 1)
  g = dy.float()
  if act == "swish":
    u = xhat.reshape(b, c, h, w) * s4 + bias.float().reshape(1, c, 1, 1)
    sig = torch.sigmoid(u)
    g = g * (sig * (1.0 + u * (1.0 - sig)))
  xhat = xhat.reshape(b, c, h, w)
  dbias = g.sum(dim=(0, 2, 3))
  dscale = (g * xhat).sum(dim=(0, 2, 3))
  gg = (g * s4).reshape(b, num_groups, -1)
  p1 = gg.mean(dim=-1, keepdim=True)
  p2 = (gg * xhat.reshape(b, num_groups, -1)).mean(dim=-1, keepdim=True)
  dx = rstd * (gg - p1 - xhat.reshape(b, num_groups, -1) * p2)
  return dx.reshape(b, c, h, w).to(x.dtype), dscale, dbias


def _kernel():
  global _fn
  if _fn is None:
    from indm_torch.ops import build
    fn = build.load("group_norm.cu").indm_group_norm_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _fn = fn
  return _fn


def _bwd_kernel():
  global _bwd_fn
  if _bwd_fn is None:
    from indm_torch.ops import build
    fn = build.load("group_norm.cu").indm_group_norm_bwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _bwd_fn = fn
  return _bwd_fn


def _check(x, scale, bias, num_groups, act):
  if x.dim() != 4:
    raise ValueError(f"group_norm_act takes NCHW input, got {tuple(x.shape)}")
  if x.dtype not in (torch.float32, torch.bfloat16):
    raise TypeError(f"group_norm_act takes float32 or bfloat16, got {x.dtype}")
  if not x.is_contiguous():
    raise ValueError("group_norm_act needs a contiguous NCHW input")
  c = x.shape[1]
  if num_groups <= 0 or c % num_groups:
    raise ValueError(f"{c} channels do not split into {num_groups} groups")
  for name, p in (("scale", scale), ("bias", bias)):
    if (p.dtype != torch.float32 or tuple(p.shape) != (c,)
        or p.device != x.device or not p.is_contiguous()):
      raise ValueError(f"{name} must be a contiguous float32 [{c}] tensor on "
                       f"{x.device}, got {p.dtype} {tuple(p.shape)} on "
                       f"{p.device}")
  if act not in ACTS:
    raise ValueError(f"act must be one of {ACTS}, got {act!r}")
  if x.numel() >= 2 ** 31:
    raise ValueError("group_norm_act indexes a row with 32-bit ints; "
                     f"{x.numel()} values are too many")


def group_norm_act(x, scale, bias, num_groups: int, eps: float = 1e-6,
                   act: str = "none"):
  """GroupNorm over NCHW x with f32 scale/bias [C], then optional swish.

  A CPU tensor takes the plain version; a CUDA tensor launches the kernel
  on the current stream (and raises on any input it does not take)."""
  global launches
  if x.device.type == "cpu":
    return group_norm_act_plain(x, scale, bias, num_groups, eps, act)
  if x.device.type != "cuda":
    raise ValueError(f"group_norm_act runs on cpu or cuda, not {x.device}")
  _check(x, scale, bias, num_groups, act)
  b, c, h, w = x.shape
  y = torch.empty_like(x)
  hw = h * w
  width = 16 // x.element_size()
  vec = int(hw % width == 0 and x.data_ptr() % 16 == 0
            and y.data_ptr() % 16 == 0)
  fn = _kernel()
  with torch.cuda.device(x.device):
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            b, c, hw, num_groups, float(eps), int(act == "swish"),
            0 if x.dtype == torch.float32 else 1, vec, stream)
  if rc != 0:
    raise RuntimeError(f"group_norm kernel launch failed with CUDA error {rc}")
  launches += 1
  return y


def _aligned(*ts) -> bool:
  return all(t.data_ptr() % 16 == 0 for t in ts)


def group_norm_act_backward(x, dy, scale, bias, num_groups: int,
                            eps: float = 1e-6, act: str = "none"):
  """(dx, dscale, dbias) of `group_norm_act` at x for the output gradient
  dy (dy of x's dtype and shape).

  A CPU tensor takes the plain version; a CUDA tensor launches the kernel
  pair (per-sample partials, then their sum over the batch in a fixed
  order) on the current stream, and raises on any input it does not
  take."""
  global bwd_launches
  if x.device.type == "cpu":
    return group_norm_act_backward_plain(x, dy, scale, bias, num_groups, eps,
                                         act)
  if x.device.type != "cuda":
    raise ValueError(f"group_norm_act_backward runs on cpu or cuda, not "
                     f"{x.device}")
  _check(x, scale, bias, num_groups, act)
  if (dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device
      or not dy.is_contiguous()):
    raise ValueError(f"dy must be a contiguous {x.dtype} {tuple(x.shape)} "
                     f"tensor on {x.device}, got {dy.dtype} "
                     f"{tuple(dy.shape)} on {dy.device}")
  b, c, h, w = x.shape
  hw = h * w
  dx = torch.empty_like(x)
  part = torch.empty((b, 2, c), device=x.device)
  grads = torch.empty((2, c), device=x.device)
  vec = int(hw % (16 // x.element_size()) == 0 and _aligned(x, dy, dx))
  fn = _bwd_kernel()
  with torch.cuda.device(x.device):
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), dy.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            dx.data_ptr(), part.data_ptr(), grads.data_ptr(), b, c, hw,
            num_groups, float(eps), int(act == "swish"),
            0 if x.dtype == torch.float32 else 1, vec, stream)
  if rc != 0:
    raise RuntimeError(f"group_norm backward kernel launch failed with CUDA "
                       f"error {rc}")
  bwd_launches += 1
  return dx, grads[0], grads[1]


class GroupNormAct(torch.autograd.Function):
  """GroupNorm(+swish) whose forward is `group_norm_act` and whose backward
  is `group_norm_act_backward`; it saves (x, scale, bias), as the TPU
  kernel pair's custom VJP does, and recomputes the statistics."""

  @staticmethod
  def forward(ctx, x, scale, bias, num_groups, eps, act):
    ctx.save_for_backward(x, scale, bias)
    ctx.cfg = (num_groups, eps, act)
    return group_norm_act(x, scale, bias, num_groups, eps, act)

  @staticmethod
  def backward(ctx, dy):
    x, scale, bias = ctx.saved_tensors
    dx, dscale, dbias = group_norm_act_backward(x, dy.contiguous(), scale,
                                                bias, *ctx.cfg)
    return dx, dscale, dbias, None, None, None
