"""The training optimizer (PyTorch).

Counterpart of `indm_tpu/state.py:32-70` for `optim.optimizer = 'AdamW'`,
the optax chain clip_by_global_norm -> scale_by_adam(b2 = 0.99) ->
add_decayed_weights -> scale_by_learning_rate, written out so that each
step is optax's:

  - the clip scales by clip / norm when the global norm reaches the clip
    (torch's `clip_grad_norm_` would use clip / (norm + 1e-6));
  - Adam's second-moment decay is 0.99 (the reference's AdamW quirk, not
    torch's 0.999), bias-corrected by the count after this update;
  - the weight decay is decoupled: p <- p - lr * (adam + wd * p);
  - the learning rate warms up linearly over `optim.warmup` updates,
    counted before this one.

`state_dict` and `load_state_dict` take `torch.optim`'s layout, which the
reference's checkpoints hold: `state` by parameter index with `step`,
`exp_avg` and `exp_avg_sq`, and `param_groups`.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch


# AdamW's second-moment decay in the reference (its Adam takes 0.999)
BETA2 = 0.99


class AdamW:
  """Updates `params` in place from their `.grad`, on their device, with no
  host read."""

  def __init__(self, params: Iterable[torch.Tensor], lr: float, beta1: float,
               eps: float, weight_decay: float, warmup: int,
               grad_clip: float):
    self.params = list(params)
    self.lr, self.beta1, self.beta2, self.eps = lr, beta1, BETA2, eps
    self.weight_decay, self.warmup, self.grad_clip = (weight_decay, warmup,
                                                      grad_clip)
    self.reset()

  def reset(self):
    """A fresh state: no update counted, both moments zero (`optim.reset`,
    `flow.optim_reset`: optax's `init` after a restore)."""
    self.count = 0
    self.mu = [torch.zeros_like(p) for p in self.params]
    self.nu = [torch.zeros_like(p) for p in self.params]

  def state_dict(self) -> dict:
    """The moments and the update count in `torch.optim.AdamW`'s layout
    (the tensors themselves, not copies)."""
    step = torch.tensor(float(self.count))
    return {
        "state": {i: {"step": step, "exp_avg": m, "exp_avg_sq": v}
                  for i, (m, v) in enumerate(zip(self.mu, self.nu))},
        "param_groups": [{
            "lr": self.lr, "betas": (self.beta1, self.beta2), "eps": self.eps,
            "weight_decay": self.weight_decay, "warmup": self.warmup,
            "grad_clip": self.grad_clip,
            "params": list(range(len(self.params)))}]}

  def load_state_dict(self, state: dict):
    """The moments and the count of `state_dict()`'s layout, copied into
    this optimizer's tensors. The hyperparameters stay the config's, as in
    the JAX package, whose optimizer state holds none."""
    entries = state["state"]
    if sorted(entries) != list(range(len(self.params))):
      raise ValueError(f"the optimizer state has {len(entries)} entries, "
                       f"the optimizer {len(self.params)} parameters")
    counts = {int(e["step"]) for e in entries.values()}
    if len(counts) > 1:
      raise ValueError(f"the parameters' step counts differ: {counts}")
    with torch.no_grad():
      for i, (m, v) in enumerate(zip(self.mu, self.nu)):
        m.copy_(entries[i]["exp_avg"])
        v.copy_(entries[i]["exp_avg_sq"])
    self.count = counts.pop() if counts else 0

  def zero_grad(self):
    for p in self.params:
      p.grad = None

  def learning_rate(self) -> float:
    if self.warmup > 0:
      return self.lr * min(self.count / self.warmup, 1.0)
    return self.lr

  @torch.no_grad()
  def step(self):
    """One update from the parameters' `.grad` (None counts as zero)."""
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in self.params]
    if self.grad_clip >= 0:
      norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
      keep = norm < self.grad_clip
      denom = torch.where(keep, torch.ones_like(norm), norm)
      mult = torch.where(keep, torch.ones_like(norm),
                         torch.full_like(norm, self.grad_clip))
      grads = torch._foreach_mul(torch._foreach_div(grads, denom), mult)
    b1, b2 = self.beta1, self.beta2
    torch._foreach_mul_(self.mu, b1)
    torch._foreach_add_(self.mu, grads, alpha=1 - b1)
    torch._foreach_mul_(self.nu, b2)
    torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
    lr = self.learning_rate()
    self.count += 1
    bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(self.count))
    bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(self.count))
    mu_hat = torch._foreach_div(self.mu, bc1)
    nu_hat = torch._foreach_div(self.nu, bc2)
    denom = torch._foreach_sqrt(nu_hat)
    torch._foreach_add_(denom, self.eps)
    update = torch._foreach_div(mu_hat, denom)
    if self.weight_decay:
      torch._foreach_add_(update, self.params, alpha=self.weight_decay)
    torch._foreach_add_(self.params, update, alpha=-lr)


def make_optimizer(config, params: Iterable[torch.Tensor],
                   lr: Optional[float] = None) -> AdamW:
  """The config's optimizer over `params`; `lr` overrides `optim.lr` (the
  flow trains at `flow.lr`)."""
  opt = config.optim
  if opt.optimizer != "AdamW":
    raise NotImplementedError(f"optimizer {opt.optimizer!r} is not ported "
                              "yet")
  return AdamW(params, lr=opt.lr if lr is None else lr, beta1=opt.beta1,
               eps=opt.eps, weight_decay=opt.weight_decay,
               warmup=opt.warmup, grad_clip=opt.grad_clip)
