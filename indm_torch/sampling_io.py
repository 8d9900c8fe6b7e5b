"""Writing one sampling round to disk (counterpart of
`indm_tpu/sampling_io.py:40-125`): uint8 NHWC arrays under the key
`samples`, before the flow in `samples_{r}_before_flow.npz` and after it
in `samples_{r}.npz`."""

from __future__ import annotations

import os

import numpy as np


def to_uint8(x) -> np.ndarray:
  """[0, 1] floats -> uint8, clipped."""
  x = np.asarray(x)
  return np.clip(x * 255.0, 0, 255).astype(np.uint8)


def sample_paths(sample_dir: str, r) -> dict:
  return {"after": os.path.join(sample_dir, f"samples_{r}.npz"),
          "before": os.path.join(sample_dir, f"samples_{r}_before_flow.npz")}


def write_round(sample_dir: str, r, before, after) -> dict:
  """Save one round's NHWC [0, 1] images; returns the two paths."""
  os.makedirs(sample_dir, exist_ok=True)
  paths = sample_paths(sample_dir, r)
  np.savez_compressed(paths["before"], samples=to_uint8(before))
  np.savez_compressed(paths["after"], samples=to_uint8(after))
  return paths
