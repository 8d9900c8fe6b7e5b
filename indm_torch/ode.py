"""Adaptive RK45 (Dormand-Prince 5(4)) integrator, PyTorch.

Counterpart of `indm_tpu/ode.py`: the same Butcher tableau, step-size
controller and initial-step heuristic (scipy's RK45), with the scalar
state (t, step size, error norm) kept in float32 as the JAX loop keeps it.
The loop runs on the host: each trial step reads its error norm from the
device once, which is one host synchronisation per 6 function
evaluations.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0], np.float64)
_A = np.zeros((6, 6), np.float64)
_A[1, 0] = 1 / 5
_A[2, :2] = [3 / 40, 9 / 40]
_A[3, :3] = [44 / 45, -56 / 15, 32 / 9]
_A[4, :4] = [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729]
_A[5, :5] = [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656]
_B = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
              np.float64)
# error weights over k[0..6] (k7 = f(t+h, y_new), first same as last)
_E = np.array([71 / 57600, 0.0, -71 / 16695, 71 / 1920, -17253 / 339200,
               22 / 525, -1 / 40], np.float64)

_f32 = np.float32
_SAFETY = _f32(0.9)
_MIN_FACTOR = _f32(0.2)
_MAX_FACTOR = _f32(10.0)
_ORDER_EXP = _f32(-1.0 / 5.0)


def _rms(x: torch.Tensor) -> np.float32:
  return _f32(torch.sqrt(torch.mean(x * x)).item())


def _lincomb(coeffs, ks):
  out = 0
  for c, k in zip(coeffs, ks):
    if c != 0.0:
      out = out + float(_f32(c)) * k
  return out


def _select_initial_step(fn, t0, y0, f0, direction, rtol, atol):
  """scipy `_ivp.common.select_initial_step`."""
  scale = atol + y0.abs() * rtol
  d0 = _rms(y0 / scale)
  d1 = _rms(f0 / scale)
  if d0 < 1e-5 or d1 < 1e-5:
    h0 = _f32(1e-6)
  else:
    h0 = _f32(_f32(0.01) * d0) / d1
  y1 = y0 + float(h0 * direction) * f0
  f1 = fn(_f32(t0 + h0 * direction), y1)
  d2 = _rms((f1 - f0) / scale) / h0
  dmax = max(d1, d2)
  if dmax <= 1e-15:
    h1 = max(_f32(1e-6), h0 * _f32(1e-3))
  else:
    h1 = (_f32(0.01) / dmax) ** _f32(1.0 / 5.0)
  return _f32(min(_f32(100) * h0, h1))


def solve_rk45(fn: Callable, t0: float, t1: float, y0: torch.Tensor,
               rtol: float = 1e-5, atol: float = 1e-5,
               max_steps: int = 10000) -> Tuple[torch.Tensor, int]:
  """Integrate dy/dt = fn(t, y) from t0 to t1 (either direction).

  fn maps (t: numpy float32 scalar, y) -> dy/dt of y's shape.
  Returns (y(t1), number of function evaluations)."""
  t0, t1 = _f32(t0), _f32(t1)
  direction = _f32(1.0) if t1 >= t0 else _f32(-1.0)
  f = fn(t0, y0)
  h_abs = _select_initial_step(fn, t0, y0, f, direction, rtol, atol)
  t, y, nfe, rejected = t0, y0, 2, False
  while nfe < 6 * max_steps:
    h_abs = min(h_abs, _f32(abs(t1 - t)))
    h = _f32(h_abs * direction)
    k = [f]
    for s in range(1, 6):
      dy = float(h) * _lincomb(_A[s, :s], k)
      k.append(fn(_f32(t + _f32(_C[s]) * h), y + dy))
    y_new = y + float(h) * _lincomb(_B, k)
    f_new = fn(_f32(t + h), y_new)
    k.append(f_new)
    err = float(h) * _lincomb(_E, k)
    nfe += 6
    scale = atol + torch.maximum(y.abs(), y_new.abs()) * rtol
    err_norm = _rms(err / scale)

    accept = err_norm < 1.0
    if accept:
      if err_norm == 0.0:
        factor = _MAX_FACTOR
      else:
        factor = min(_MAX_FACTOR, _SAFETY * err_norm ** _ORDER_EXP)
      if rejected:
        factor = min(_f32(1.0), factor)
      t, y, f = _f32(t + h), y_new, f_new
    else:
      factor = max(_MIN_FACTOR, _SAFETY * err_norm ** _ORDER_EXP)
    h_abs = _f32(h_abs * factor)
    rejected = not accept
    if direction * (t1 - t) <= 0.0:
      break
  return y, nfe
