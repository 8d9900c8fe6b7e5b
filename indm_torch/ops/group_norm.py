"""GroupNorm (+ optional swish) forward: the Hopper kernel and its plain
version.

`group_norm_act` is the wrapper the score net calls. On a CUDA tensor it
launches the hand-written kernel of `indm_torch/csrc/group_norm.cu` (which
replaces the TPU kernel `indm_tpu/ops/group_norm_pallas.py:_fwd_call`) or
raises; on a CPU tensor it computes `group_norm_act_plain`. The kernel's
design, its numerical contract and its bound are in the source's note.

`launches` counts the kernel launches made by `group_norm_act`, so that a
run can show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

ACTS = ("none", "swish")

launches = 0

_fn = None


def reset_launches():
  global launches
  launches = 0


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
