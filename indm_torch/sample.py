"""Sample images with the port: the sampling half of `run_lib.evaluate`.

  python -m indm_torch.sample --config vp/CIFAR10/indm_nll --batch 64 \
      --rounds 1 --workdir runs/sample [--device cpu] \
      [--set model.fused_groupnorm=true ...]
  python -m indm_torch.sample --config ve/CIFAR10/indm --workdir runs/ve

Without a checkpoint (loading one is not ported yet) the models run on
initial weights drawn from `config.seed`. Each round writes
`samples_{r}.npz` and `samples_{r}_before_flow.npz` (uint8 NHWC) under
`<workdir>/eval`, and for the PC sampler also the step-(N-2) mean in
`samples_{r}_before_flow_for_search.npz`, and prints its function
evaluations, seconds and images per second.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from indm_torch import run_lib, sampling_io
from indm_torch.configs import get_config


def _sync(device):
  if torch.device(device).type == "cuda":
    torch.cuda.synchronize(device)


def run(config, workdir: str, batch: int, rounds: int, device="cuda",
        log=print):
  """Sample `rounds` rounds of `batch` images; returns one dict per round
  with nfe, seconds, images_per_s, the NHWC images before and after the
  flow (CPU float tensors) and the written paths."""
  s = run_lib.build_sampling(config, batch, device=device)
  sample_dir = os.path.join(workdir, "eval")
  out = []
  for r in range(rounds):
    gen = torch.Generator(device=device).manual_seed(config.seed + 1000 + r)
    _sync(device)
    t0 = time.perf_counter()
    before, after, search, nfe = run_lib.sample_round(config, s,
                                                      generator=gen)
    _sync(device)
    seconds = time.perf_counter() - t0
    before, after = before.float().cpu(), after.float().cpu()
    paths = sampling_io.write_round(
        sample_dir, r, before.numpy(), after.numpy(),
        None if search is None else search.float().cpu().numpy())
    stats = {"round": r, "nfe": nfe, "seconds": seconds,
             "images_per_s": batch / seconds}
    log(f"round {r}: nfe={nfe} seconds={seconds:.3f} "
        f"images/s={batch / seconds:.3f}")
    out.append({**stats, "before": before, "after": after, "paths": paths})
  return out


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  p.add_argument("--config", default="vp/CIFAR10/indm_nll")
  p.add_argument("--batch", type=int, default=64)
  p.add_argument("--rounds", type=int, default=1)
  p.add_argument("--workdir", required=True)
  p.add_argument("--device", default="cuda")
  p.add_argument("--set", action="append", default=[], metavar="LEAF=VALUE",
                 help="override a config leaf, e.g. model.fused_groupnorm=true")
  args = p.parse_args(argv)
  config = get_config(args.config)
  for item in args.set:
    name, _, value = item.partition("=")
    config.set_dotted(name, value)
  config.sampling.batch_size = args.batch
  run(config, args.workdir, args.batch, args.rounds, device=args.device)


if __name__ == "__main__":
  main()
