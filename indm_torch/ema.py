"""Exponential moving average of parameters (PyTorch).

Counterpart of `indm_tpu/ema.py:16-26`: one step with the warm-up decay
min(decay, (1 + n) / (10 + n)), n the count of updates including this one.
`state_dict` is the reference's layout, `{"decay", "num_updates",
"shadow_params"}` with the shadow a list in the module's `parameters()`
order.
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

  def reset(self, params: Iterable[torch.Tensor]):
    """The shadow set to `params` and the count to 0 (the JAX package's
    score EMA when a flow has no checkpoint yet)."""
    with torch.no_grad():
      for s, p in zip(self.shadow, params, strict=True):
        s.copy_(p)
    self.num_updates = 0

  def state_dict(self) -> dict:
    return {"decay": self.decay, "num_updates": self.num_updates,
            "shadow_params": self.shadow}

  def load_state_dict(self, state: dict):
    shadow = state["shadow_params"]
    if len(shadow) != len(self.shadow):
      raise ValueError(f"the EMA state has {len(shadow)} shadow tensors, "
                       f"the model {len(self.shadow)} parameters")
    with torch.no_grad():
      for s, v in zip(self.shadow, shadow):
        s.copy_(v)
    self.decay = state["decay"]
    self.num_updates = int(state["num_updates"])

  def copy_to(self, module: torch.nn.Module):
    """The shadow into `module`'s parameters, for evaluation (the
    reference's `copy_to`; the JAX package evaluates on `ema_params`)."""
    params = list(module.parameters())
    if len(params) != len(self.shadow):
      raise ValueError("the module's parameters are not the EMA's")
    with torch.no_grad():
      for p, s in zip(params, self.shadow):
        p.copy_(s)
