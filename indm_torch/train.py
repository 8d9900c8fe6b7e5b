"""Train INDM with the port: the joint flow + score step, the training
half of `run_lib.train`.

  python -m indm_torch.train --config vp/CIFAR10/indm_nll --steps 3 \
      [--workdir runs/train] [--batch 128] [--device cuda] \
      [--set flow.logdet_pallas=true ...]

`--config vp/CIFAR10/indm_nll` trains the likelihood variant (`step_nll`),
`--config vp/CIFAR10/indm_fid` the FID variant (`step_fid`: phase 1 the
joint loss with importance sampling updates the flow, phase 2 the score
loss on the updated flow's latent updates the score net);
`vp/CELEBA/indm_nll` and `vp/CELEBA/indm_fid` are the same at 64x64 (the
flow squeezes the image to 32x32x12 first). With
`--workdir` and `training.snapshot_sampling` (on in both configs), a step
that brings the count to a multiple of
`training.snapshot_freq_for_preemption` also samples `eval.num_samples`
images into `<workdir>/samples/iter_{step}/` and prints their FID and IS
(`python -m indm_torch.evaluate` explains the line).

Weights start from `config.seed`; the data are the training split on disk
(`data.load_arrays`: CIFAR-10's pickles, `<dataset>.npz`, or CelebA's
image folder `celeba/` with its `celeba_64.npz` cache, under `datadir`
or `$INDM_DATA_DIR`), else the seeded synthetic images.
`python -m indm_torch.main --mode train` runs the whole loop to
`training.n_iters`; this command runs `--steps` steps.
Each step prints the means of the loss and its score, flow and prior
terms, and its seconds. With `--workdir` the state is restored from that
directory's meta checkpoint when there is one, and written back as the
JAX package's loop writes it: the meta pair
(`checkpoints-meta/checkpoint.pth`, `flow_checkpoint.pth`) every
`training.snapshot_freq_for_preemption` steps and after the call's last
step, the numbered pair (`checkpoints/checkpoint_{k}.pth`,
`flow_checkpoint_{k}.pth`, k = step // `training.snapshot_freq`) every
`training.snapshot_freq` steps. A second call with the same work directory
goes on from the saved step: the parameters, the optimizers' moments and
counts, the EMAs, the BatchNorm statistics, the batches' place
and every generator are restored, so that N steps and then M steps give
the bits of N + M steps in one call. For that the command turns the
config's `optim.reset` off (the JAX package's switch to start a fresh
score optimizer from a checkpoint); `--set optim.reset=true` turns it on.

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

The JAX package's own benchmark configuration (`bench.py:56-80`) runs the
fused kernels in their bfloat16 mode and the score net in mixed precision
(bfloat16 convs, NIN and attention from float32 master weights), with
GroupNorm left to PyTorch:

  python -m indm_torch.train --steps 3 --set flow.fused_block=true \
      --set flow.logdet_bf16=true --set flow.mixed_precision=true \
      --set model.mixed_precision=true --set model.fast_dropout=true \
      --set model.fused_groupnorm=false

Its chain route (`bench.py` with BENCH_FUSED_BLOCK=0) runs the chain kernel
in its bfloat16 mode in every block, and with INDM_FUSED_CHAIN=1 the fully
fused chain in its bfloat16 mode:

  [INDM_FUSED_CHAIN=1] python -m indm_torch.train --steps 3 \
      --set flow.logdet_bf16=true --set flow.mixed_precision=true \
      --set model.mixed_precision=true --set model.fast_dropout=true \
      --set model.fused_groupnorm=false

`--set flow.logdet_unroll=N` truncates the log-det series at N terms on
every route, as the JAX package's fixed unroll does.
"""

from __future__ import annotations

import argparse

from indm_torch import run_lib
from indm_torch.configs import get_config


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  p.add_argument("--config", default="vp/CIFAR10/indm_nll")
  p.add_argument("--steps", type=int, default=1,
                 help="steps in this call")
  p.add_argument("--workdir", default=None,
                 help="read and write checkpoints here")
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
  config.optim.reset = False
  for item in args.set:
    name, _, value = item.partition("=")
    config.set_dotted(name, value)
  if args.batch is not None:
    config.training.batch_size = args.batch
  tr = run_lib.build_training(config, device=args.device, seed=args.seed,
                              workdir=args.workdir)
  return run_lib.train_steps(tr, args.steps)


if __name__ == "__main__":
  main()
