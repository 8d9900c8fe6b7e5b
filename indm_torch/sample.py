"""Sample images with the port: the sampling half of `run_lib.evaluate`.

  python -m indm_torch.sample --config vp/CIFAR10/indm_nll --batch 64 \
      --rounds 1 --workdir runs/sample [--device cpu] \
      [--set model.fused_groupnorm=true ...]
  python -m indm_torch.sample --config ve/CIFAR10/indm --workdir runs/ve

The models are read from `<workdir>`'s checkpoint, the meta pair that
`python -m indm_torch.train --workdir` writes (or the numbered pair of
`--set eval.target_ckpt=K`), with the score net's EMA under
`eval.score_ema` (on by default) and the flow's raw parameters; without a
checkpoint they run on initial weights drawn from `config.seed`, with a
warning. Without a card it raises unless `--device cpu` is given. Each
round writes
`samples_{r}.npz` and `samples_{r}_before_flow.npz` (uint8 NHWC) under
`<workdir>/eval`, and for the PC sampler also the step-(N-2) mean in
`samples_{r}_before_flow_for_search.npz`, and prints its function
evaluations, seconds and images per second.
"""

from __future__ import annotations

import argparse
import os

from indm_torch import run_lib
from indm_torch.configs import get_config


def run(config, workdir: str, batch: int, rounds: int, device="cuda",
        log=print):
  """Sample `rounds` rounds of `batch` images from the checkpoint in
  `workdir` (initial weights without one) into `<workdir>/eval`; returns
  one dict per round with nfe, seconds, images_per_s, the NHWC images
  before and after the flow (CPU float tensors) and the written paths."""
  s = run_lib.build_sampling(config, batch, device=device, workdir=workdir)
  return run_lib.sample_rounds(config, s, os.path.join(workdir, "eval"),
                               batch, rounds, log)


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
