"""Train INDM with the port: the joint flow + score step of the likelihood
variant, the training half of `run_lib.train`.

  python -m indm_torch.train --config vp/CIFAR10/indm_nll --steps 3 \
      [--batch 128] [--device cuda] [--set flow.logdet_pallas=true ...]

Weights start from `config.seed` (loading and writing checkpoints is not
ported yet); the data are the seeded synthetic images. Each step prints the
means of the loss and its score, flow and prior terms, and its seconds.

The command runs the configuration whose TPU kernels the port has:
`model.fused_groupnorm=True` (the score net's GroupNorm, forward and
backward, through the port's kernels) and `flow.logdet_pallas=True` (the
flow's Neumann chain as a kernel, then autograd). `--set` can turn the
GroupNorm kernels off. Without a card it raises unless `--device cpu` is
given, where every kernel takes its plain version.

The fused kernels replace the chain and autograd with
`flow.fused_block=true`, as in the JAX package: each scale's scanned stack
of pre-activated blocks runs through the stack kernels (one call per scale
and direction), and the flow's first block through the fused iResBlock
pair (forward with the chain and J^T u, analytic backward):

  python -m indm_torch.train --steps 3 --set flow.fused_block=true

The JAX package's switch INDM_FUSED_STACK=0 in the environment runs every
block through the fused pair instead. On the chain route, its switch
INDM_FUSED_CHAIN=1 runs each block's chain through the fully fused chain
kernel, which makes the activation derivatives from the block input in the
same call (the width must be 33 or more):

  INDM_FUSED_CHAIN=1 python -m indm_torch.train --steps 3
"""

from __future__ import annotations

import argparse

from indm_torch import run_lib
from indm_torch.configs import get_config


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  p.add_argument("--config", default="vp/CIFAR10/indm_nll")
  p.add_argument("--steps", type=int, default=1)
  p.add_argument("--batch", type=int, default=None,
                 help="training batch (default: the config's, 128)")
  p.add_argument("--device", default="cuda")
  p.add_argument("--seed", type=int, default=None)
  p.add_argument("--set", action="append", default=[], metavar="LEAF=VALUE",
                 help="override a config leaf, e.g. model.dropout=0.0")
  args = p.parse_args(argv)
  config = get_config(args.config)
  config.model.fused_groupnorm = True
  config.flow.logdet_pallas = True
  for item in args.set:
    name, _, value = item.partition("=")
    config.set_dotted(name, value)
  if args.batch is not None:
    config.training.batch_size = args.batch
  tr = run_lib.build_training(config, device=args.device, seed=args.seed)
  return run_lib.train_steps(tr, args.steps)


if __name__ == "__main__":
  main()
