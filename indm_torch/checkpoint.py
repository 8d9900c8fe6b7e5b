"""Checkpoint save and restore (PyTorch): one `torch.save` dict per stream.

Counterpart of `indm_tpu/checkpoint.py:26 save_checkpoint, :35
restore_checkpoint`, in the reference's torch layout: each of the two
streams (`checkpoint.pth` for the score net, `flow_checkpoint.pth` for the
flow) is `{"optimizer", "model", "ema", "step"}`, with `model` the
module's `state_dict()` (whose keys are the reference's), `ema` the
reference's `{"decay", "num_updates", "shadow_params"}` and `optimizer`
`torch.optim`'s layout (`indm_torch.optim.AdamW.state_dict`). The score
stream also holds the generators' states under `"rng"`, as the JAX
package's `TrainState` carries its key. Every entry is a tensor or a plain
Python value, so that the file loads with `weights_only=True`.

Semantics kept from the JAX package:
  * a file is written to a temporary name, then moved over the old one;
  * restoring a file that does not exist leaves the state as it is, with
    a warning (the automatic resume after preemption);
  * the optimizer's state is not restored under VESDE unless
    `keep_optimizer=True` (the flow's stream always passes it).
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch


def stream_state(model: torch.nn.Module, optimizer, ema, step: int,
                 **extra) -> dict:
  """One stream's dict: `{"optimizer", "model", "ema", "step"}` and the
  `extra` entries."""
  return {"optimizer": optimizer.state_dict(), "model": model.state_dict(),
          "ema": ema.state_dict(), "step": int(step), **extra}


def save_checkpoint(ckpt_path: str, state: dict) -> None:
  """`state` to `ckpt_path` through a temporary file and `os.replace`."""
  os.makedirs(os.path.dirname(ckpt_path), exist_ok=True)
  tmp = ckpt_path + ".tmp"
  torch.save(state, tmp)
  os.replace(tmp, ckpt_path)


def restore_checkpoint(config, ckpt_path: str, model: torch.nn.Module,
                       optimizer=None, ema=None,
                       keep_optimizer: Optional[bool] = None
                       ) -> Optional[dict]:
  """Load `ckpt_path` into `model`, `ema` and `optimizer` in place (each
  optional but the model) and return the file's dict, whose `step` and
  other entries the caller reads; None, with nothing changed, if the file
  does not exist. `keep_optimizer` defaults to "not VESDE"."""
  if not os.path.exists(ckpt_path):
    os.makedirs(os.path.dirname(ckpt_path), exist_ok=True)
    logging.warning("No checkpoint found at %s. Returned the same state as "
                    "input", ckpt_path)
    return None
  device = next(model.parameters()).device
  state = torch.load(ckpt_path, map_location=device, weights_only=True)
  logging.info("%s loaded ...", ckpt_path)
  model.load_state_dict(state["model"])
  if ema is not None:
    ema.load_state_dict(state["ema"])
  if keep_optimizer is None:
    keep_optimizer = config.training.sde != "vesde"
  if optimizer is not None and keep_optimizer:
    optimizer.load_state_dict(state["optimizer"])
  return state
