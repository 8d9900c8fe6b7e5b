"""Compare implementations of the narrow-channel 3x3 SAME convs on the card.

The port of the JAX package's `scripts/bench_narrow_conv.py`. The 3-1-3
Lipschitz nets of the flow start and end with (3 <-> 512)-channel convs;
two kinds, three implementations each:

  plain   `narrow_conv_plain`: the packed-tap arithmetic in plain tensor
          ops (the JAX script's dot_trick)
  direct  `torch.nn.functional.conv2d` (its lax.conv_general_dilated)
  cuda    `narrow_conv`: the kernel of `indm_torch/csrc/narrow_conv.cu`
          (its pallas case)

  python -m indm_torch.scripts.bench_narrow_conv [--device cuda]

NC_BATCH and NC_HW in the environment set the batch and the image size
(default 128 and 32), as in the JAX script. Its NC_BT, the TPU kernel's
batch tile, means nothing on the card and is not read. The inputs are the
JAX script's draws from numpy's default_rng(0), in its order (weights
times 0.05), rounded to float32 and then to bfloat16, and moved to NCHW
and OIHW. Each case prints its milliseconds (CUDA events around 100 calls
after 3; on a CPU the host's clock) and its largest deviation from the
kind's first case. `--device cpu` runs every case on the CPU, where the
cuda case takes the plain version: use small NC_* values there.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from indm_torch.ops.narrow_conv import narrow_conv, narrow_conv_plain

C, IDIM = 3, 512
REPS, WARMUP = 100, 3


def direct(x, w):
  return F.conv2d(x, w, padding=1)


IMPLS = (("plain", narrow_conv_plain), ("direct", direct),
         ("cuda", narrow_conv))


def inputs(batch, hw, dtype, device):
  """{kind: (x NCHW, w OIHW)} from the JAX script's draws."""
  rng = np.random.default_rng(0)
  x_n = rng.standard_normal((batch, hw, hw, C)).astype(np.float32)
  x_w = rng.standard_normal((batch, hw, hw, IDIM)).astype(np.float32)
  w_in = (rng.standard_normal((3, 3, C, IDIM)) * 0.05).astype(np.float32)
  w_out = (rng.standard_normal((3, 3, IDIM, C)) * 0.05).astype(np.float32)

  def t(a, perm):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(perm))).to(
        device=device, dtype=dtype)

  return {"narrow_in": (t(x_n, (0, 3, 1, 2)), t(w_in, (3, 2, 0, 1))),
          "narrow_out": (t(x_w, (0, 3, 1, 2)), t(w_out, (3, 2, 0, 1)))}


def time_ms(fn, device, reps=REPS):
  """Milliseconds per call: CUDA events on a card, else the host clock."""
  for _ in range(WARMUP):
    fn()
  if device.type == "cuda":
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
      fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps
  t0 = time.perf_counter()
  for _ in range(reps):
    fn()
  return (time.perf_counter() - t0) / reps * 1e3


def run(batch=128, hw=32, dtype=torch.bfloat16, device="cuda", reps=REPS,
        log=print):
  """The six cases; returns one dict per case, in order: name, kind, impl,
  ms, max_dev (from the kind's first case, plain), max_dev_direct (from
  the direct case) and largest (the plain output's largest magnitude)."""
  device = torch.device(device)
  rows = []
  for kind, (x, w) in inputs(batch, hw, dtype, device).items():
    cin, cout = x.shape[1], w.shape[0]
    outs = {impl: fn(x, w).float() for impl, fn in IMPLS}
    largest = outs["plain"].abs().max().item()
    for impl, fn in IMPLS:
      name = f"{kind:10s} ({cin}->{cout}) {impl}"
      ms = time_ms(lambda: fn(x, w), device, reps)
      row = {"name": name, "kind": kind, "impl": impl, "ms": ms,
             "max_dev": (outs[impl] - outs["plain"]).abs().max().item(),
             "max_dev_direct": (outs[impl]
                                - outs["direct"]).abs().max().item(),
             "largest": largest}
      log(f"{name:36s}: {ms:8.3f} ms   (max dev vs first: "
          f"{row['max_dev']:.2e})")
      rows.append(row)
    del outs
  return rows


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  p.add_argument("--device", default="cuda")
  args = p.parse_args(argv)
  device = torch.device(args.device)
  if device.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("no CUDA card: pass --device cpu to run the cases on "
                       "the CPU")
  batch = int(os.environ.get("NC_BATCH", 128))
  hw = int(os.environ.get("NC_HW", 32))
  name = (torch.cuda.get_device_name(device) if device.type == "cuda"
          else "cpu")
  print(f"narrow convs, batch {batch}, {hw}x{hw}, bfloat16, on {name}",
        flush=True)
  return run(batch, hw, torch.bfloat16, device)


if __name__ == "__main__":
  main()
