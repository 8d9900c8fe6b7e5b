"""Writing one sampling round to disk (counterpart of
`indm_tpu/sampling_io.py:40-125`): uint8 NHWC arrays under the key
`samples`, before the flow in `samples_{r}_before_flow.npz` and after it
in `samples_{r}.npz`; the PC sampler's step-(N-2) mean, which the VE
denoise search resumes from, in `samples_{r}_before_flow_for_search.npz`."""

from __future__ import annotations

import os

import numpy as np


def to_uint8(x) -> np.ndarray:
  """[0, 1] floats -> uint8, clipped."""
  x = np.asarray(x)
  return np.clip(x * 255.0, 0, 255).astype(np.uint8)


def sample_paths(sample_dir: str, r) -> dict:
  return {"after": os.path.join(sample_dir, f"samples_{r}.npz"),
          "before": os.path.join(sample_dir, f"samples_{r}_before_flow.npz"),
          "search": os.path.join(sample_dir,
                                 f"samples_{r}_before_flow_for_search.npz")}


def write_round(sample_dir: str, r, before, after, search=None) -> dict:
  """Save one round's NHWC [0, 1] images (and the search state, when
  given); returns the paths written."""
  os.makedirs(sample_dir, exist_ok=True)
  arrays = {"before": before, "after": after, "search": search}
  paths = {key: path for key, path in sample_paths(sample_dir, r).items()
           if arrays[key] is not None}
  for key, path in paths.items():
    np.savez_compressed(path, samples=to_uint8(arrays[key]))
  return paths
