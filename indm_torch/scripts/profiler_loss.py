"""How often torch.profiler loses the launch records of kernel 7 on the card.

  python -m indm_torch.scripts.profiler_loss [--rounds 12]

One call of `neumann_chain` (n = 2, the training offset: four terms of
three launches each, conv_in, the 512-wide product and conv_out) at both of
the flow's full-width scales at batch 128, in float32 and bfloat16, is
profiled again and again, each time in one of these ways:

  plain       the call and a synchronise, nothing else in the window
  pad_before  50 ms of idle host time before the call
  pad_after   250 ms of idle host time after the synchronise
  marker      the call inside `record_function`
  twice       two calls in one window

A profile is whole when its device records show every launch of the
window in order. The host's own counts (`device_gemm_launches`,
`device_conv_launches`) must show every launch of every call, or the
script fails. Prints each profile that is not whole (its records, one
letter a launch: i conv_in, g the product, o conv_out), then one JSON line:
whole and not whole by way of profiling.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import time

import torch

CUDA = torch.autograd.DeviceType.CUDA
LETTERS = {"conv_in_kernel": "i", "wgmma": "g", "conv_out_kernel": "o"}
SCALES = ((3, 32), (12, 16))
BATCH, WIDTH, N = 128, 512, 2


def chain_args(c, hw, dtype, gen):
  """Inputs of one pre-activated chain call: vareps, the diagonals
  cos(2 pi a) and weights of variance 1 / fan_in."""
  from indm_torch.flows.resflow import OFFSET_TRAIN, RCDF_TRAIN

  def randn(*shape):
    return torch.randn(shape, device="cuda", generator=gen)

  ws = [randn(*s) / math.sqrt(s[1] * s[2] * s[3])
        for s in ((WIDTH, c, 3, 3), (WIDTH, WIDTH, 1, 1), (c, WIDTH, 3, 3))]
  dacts = [torch.cos(2 * math.pi * randn(BATCH, d, hw, hw))
           for d in (WIDTH, WIDTH, c)]
  return ((randn(BATCH, c, hw, hw).to(dtype), [d.to(dtype) for d in dacts],
           [w.to(dtype).contiguous() for w in ws], N, OFFSET_TRAIN,
           RCDF_TRAIN), N + OFFSET_TRAIN)


def records(p):
  """The profile's device records of the chain's launches, in order."""
  acts = sorted((e for e in p.events() if e.device_type == CUDA),
                key=lambda e: e.time_range.start)
  return "".join(next((v for k, v in LETTERS.items() if k in e.name), "")
                 for e in acts)


def profiled(way, fn):
  """Profile fn() the given way; returns the profiler and the calls."""
  from torch.profiler import ProfilerActivity, profile, record_function
  calls = 2 if way == "twice" else 1
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as p:
    if way == "pad_before":
      time.sleep(0.05)
    if way == "marker":
      with record_function("chain"):
        fn()
    else:
      for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    if way == "pad_after":
      time.sleep(0.25)
  return p, calls


def main():
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("--rounds", type=int, default=12)
  rounds = ap.parse_args().rounds
  from indm_torch.ops import lipnet_gemm as lg
  from indm_torch.ops import neumann
  gen = torch.Generator(device="cuda").manual_seed(11)
  setups = {f"{str(dt)[6:]} [{BATCH},{c},{hw},{hw}]": chain_args(c, hw, dt, gen)
            for c, hw in SCALES for dt in (torch.float32, torch.bfloat16)}
  ways = ("plain", "pad_before", "pad_after", "marker", "twice")
  tally = {w: collections.Counter() for w in ways}
  t0 = time.perf_counter()
  for _ in range(rounds):
    for name, (args, terms) in setups.items():
      def fn():
        neumann.neumann_chain(*args)
      fn()
      torch.cuda.synchronize()
      for way in ways:
        gemms = sum(lg.device_gemm_launches().values())
        convs = lg.device_conv_launches("neumann_chain.cu")
        p, calls = profiled(way, fn)
        host = (sum(lg.device_gemm_launches().values()) - gemms,
                *(v - convs[k] for k, v in
                  lg.device_conv_launches("neumann_chain.cu").items()))
        if host != (terms * calls,) * 3:
          raise AssertionError(f"{name} {way}: the host counted {host} "
                               f"launches (products, conv_in, conv_out) in "
                               f"{terms * calls} terms")
        seen = records(p)
        whole = seen == "igo" * terms * calls
        tally[way]["whole" if whole else "not whole"] += 1
        if not whole:
          print(f"{time.perf_counter() - t0:.1f} s {way} {name}: "
                f"records {seen!r}", flush=True)
  print(json.dumps({w: dict(c) for w, c in tally.items()}), flush=True)


if __name__ == "__main__":
  main()
