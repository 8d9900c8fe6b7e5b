"""Sampling rounds on disk and their cache (counterpart of
`indm_tpu/sampling_io.py:21-159`).

Every artefact is a uint8 NHWC array under the key `samples`, named by
its round: after the flow `samples_{r}{suffix}.npz`, before it
`samples_{r}_before_flow{suffix}.npz`, the plain PC loop's step-(N-2) mean
`samples_{r}_before_flow_for_search.npz`, and a PNG grid of the first 64
images after the flow `samples_{r}{suffix}.png`, written by
`image_io.write_png` (no PIL). The suffix is `_denoise_{t}` under
`sampling.pc_denoise` and `_more_step` under `sampling.more_step`. A round
whose after-flow file exists is not sampled again; one whose before-flow
file exists gets the flow inverse again, in chunks of 16; the denoise
search and the extra steps resume a cached trajectory instead of sampling
the prior.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Optional

import numpy as np
import torch

from indm_torch import data as data_lib
from indm_torch import image_io


def to_uint8(x) -> np.ndarray:
  """[0, 1] floats -> uint8, clipped."""
  x = np.asarray(x)
  return np.clip(x * 255.0, 0, 255).astype(np.uint8)


def image_grid(samples: np.ndarray, grid_size: Optional[int] = None):
  """Tile [N,H,W,C] uint8 samples into one grid image of grid_size x
  grid_size of them (default floor(sqrt(N)))."""
  n, h, w, c = samples.shape
  if grid_size is None:
    grid_size = int(np.floor(np.sqrt(n)))
  g = samples[:grid_size * grid_size].reshape(grid_size, grid_size, h, w, c)
  return g.transpose(0, 2, 1, 3, 4).reshape(grid_size * h, grid_size * w, c)


def save_png(path: str, samples: np.ndarray):
  """The grid of `samples` as an 8-bit PNG: RGB, or gray for one
  channel."""
  g = image_grid(samples)
  image_io.write_png(path, g, color_type=0 if g.shape[-1] == 1 else 2)


def sample_paths(config, sample_dir: str, r) -> dict:
  """The round's files: "after" and "before" (both with the variant's
  suffix), "base" (the unsuffixed before-flow file that the extra steps
  resume from), "search" (the step-(N-2) mean) and "png"."""
  suffix = ""
  if config.sampling.pc_denoise:
    suffix = f"_denoise_{config.sampling.pc_denoise_time}"
  elif config.sampling.more_step:
    suffix = "_more_step"
  join = lambda name: os.path.join(sample_dir, name)
  return {"after": join(f"samples_{r}{suffix}.npz"),
          "before": join(f"samples_{r}_before_flow{suffix}.npz"),
          "base": join(f"samples_{r}_before_flow.npz"),
          "search": join(f"samples_{r}_before_flow_for_search.npz"),
          "png": join(f"samples_{r}{suffix}.png")}


def _load01(path: str) -> np.ndarray:
  with np.load(path) as z:
    return z["samples"].astype(np.float32) / 255.0


def get_samples(config, flow_inverse, sample_round: Callable, r,
                sample_dir: str, temperature: float = 1.0, device="cpu",
                log: Callable = logging.info) -> dict:
  """One round through the cache (`indm_tpu/sampling_io.py:68-125`):

  1. with `samples_{r}{suffix}.npz` on disk, its images, and nothing runs;
  2. with the before-flow file on disk, the flow inverse again on it
     (`apply_flow_inverse_chunked`), the after-flow file written;
  3. otherwise `sample_round(before_data=..., final_time=...)` runs, from
     a cached trajectory where the variant resumes one (under
     `sampling.pc_denoise` the VE SDE's step-(N-2) file, else the base
     before-flow file; the final time `sampling.pc_denoise_time` under
     `pc_denoise`, else 0) or from the prior, and its files and the PNG
     grid are written.

  `sample_round` returns (before, after, step-(N-2) mean or None, nfe),
  NHWC in [0, 1]. Returns {"after": the uint8 images after the flow,
  "cached": "after", "before" or None, "resumed": the resumed file or
  None, "sampled": sample_round's output or None, "paths": the files
  written}."""
  os.makedirs(sample_dir, exist_ok=True)
  paths = sample_paths(config, sample_dir, r)
  out = {"cached": None, "resumed": None, "sampled": None, "paths": {}}
  if os.path.exists(paths["after"]):
    with np.load(paths["after"]) as z:
      return {**out, "after": z["samples"], "cached": "after"}
  if os.path.exists(paths["before"]):
    after = to_uint8(apply_flow_inverse_chunked(
        config, flow_inverse, _load01(paths["before"]), temperature,
        device=device))
    np.savez_compressed(paths["after"], samples=after)
    return {**out, "after": after, "cached": "before",
            "paths": {"after": paths["after"]}}

  final_time = (config.sampling.pc_denoise_time if config.sampling.pc_denoise
                else 0.0)
  before_data = None
  if config.sampling.pc_denoise or config.sampling.more_step:
    src = (paths["search"] if config.sampling.pc_denoise
           and config.training.sde == "vesde" else paths["base"])
    if os.path.exists(src):
      raw = data_lib.get_data_scaler(config)(_load01(src))
      before_data = torch.from_numpy(np.ascontiguousarray(
          raw.transpose(0, 3, 1, 2))).to(device)
      out["resumed"] = src
      log(f"round {r}: resuming cached trajectory {os.path.basename(src)} "
          f"(final_time={final_time})")
  sampled = sample_round(before_data=before_data, final_time=final_time)
  before, after, search = (None if v is None else v.float().cpu().numpy()
                           for v in sampled[:3])
  written = {"before": before, "after": after, "search": search}
  for key, value in written.items():
    if value is not None:
      np.savez_compressed(paths[key], samples=to_uint8(value))
      out["paths"][key] = paths[key]
  after_u8 = to_uint8(after)
  save_png(paths["png"], after_u8[:64])
  out["paths"]["png"] = paths["png"]
  return {**out, "after": after_u8, "sampled": sampled}


def apply_flow_inverse_chunked(config, flow_inverse, before01: np.ndarray,
                               temperature: float, chunk: int = 16,
                               device="cpu") -> np.ndarray:
  """The flow inverse on [0, 1] NHWC images before the flow, in chunks of
  `chunk` (`indm_tpu/sampling_io.py:128-143`): each chunk scaled to the
  model's range, times `temperature`, through `flow_inverse` (the
  identity when None) on `device`, and scaled back; NHWC float32."""
  scaler = data_lib.get_data_scaler(config)
  inverse = data_lib.get_data_inverse_scaler(config)
  outs = []
  for i in range(0, len(before01), chunk):
    x = torch.from_numpy(np.ascontiguousarray(
        scaler(before01[i:i + chunk]).transpose(0, 3, 1, 2))).to(device)
    with torch.no_grad():
      z = flow_inverse(x * temperature) if flow_inverse is not None else x
    outs.append(inverse(z).permute(0, 2, 3, 1).float().cpu().numpy())
  return np.concatenate(outs)


def load_all_samples(config, sample_dir: str) -> np.ndarray:
  """Every cached after-flow round of `sample_dir`, in the order of their
  names, as one uint8 array (empty [0, H, W, C] when there is none)."""
  outs = []
  for name in sorted(os.listdir(sample_dir)):
    if (name.startswith("samples_") and name.endswith(".npz")
        and "before_flow" not in name):
      with np.load(os.path.join(sample_dir, name)) as z:
        outs.append(z["samples"])
  if not outs:
    return np.zeros((0, config.data.image_size, config.data.image_size,
                     config.data.num_channels), np.uint8)
  return np.concatenate(outs)
