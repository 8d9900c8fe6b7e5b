"""Exponential moving average of parameters (PyTorch).

Counterpart of `indm_tpu/ema.py:16-26`: one step with the warm-up decay
min(decay, (1 + n) / (10 + n)), n the count of updates including this one.
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np
import torch


def ema_update(ema_params: List[torch.Tensor], params: List[torch.Tensor],
               decay: float, num_updates: int):
  """e <- e - (1 - d) * (e - p) in place, with d computed in float32 as the
  JAX package computes it."""
  n = np.float32(num_updates)
  d = min(np.float32(decay), (np.float32(1.0) + n) / (np.float32(10.0) + n))
  one_minus = float(np.float32(1.0) - d)
  with torch.no_grad():
    diff = torch._foreach_sub(ema_params, params)
    torch._foreach_mul_(diff, one_minus)
    torch._foreach_sub_(ema_params, diff)


class EMA:
  """The shadow parameters of a module and their update count."""

  def __init__(self, params: Iterable[torch.Tensor], decay: float):
    self.decay = decay
    self.num_updates = 0
    self.shadow = [p.detach().clone() for p in params]

  def update(self, params: Iterable[torch.Tensor]):
    self.num_updates += 1
    ema_update(self.shadow, [p.detach() for p in params], self.decay,
               self.num_updates)
