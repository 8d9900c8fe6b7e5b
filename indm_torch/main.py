"""Train or evaluate INDM with the port, as the JAX package's `main.py`
does (`python main.py --mode {train,eval} --config ... --workdir ...`).

  python -m indm_torch.main --mode train --config ve/CIFAR10/indm \
      --workdir runs/ve [--set training.n_iters=1000 ...] [--device cpu]
  python -m indm_torch.main --mode eval --config ve/CIFAR10/indm \
      --workdir runs/ve [--set eval.data_mean=true ...]
  python -m indm_torch.main --mode train --config ve/CELEBA/indm \
      --workdir runs/celeba --set datadir=DIR

`--mode train` runs `run_lib.train`: the joint flow + score step from the
work directory's meta checkpoint (step 0 without one) through step
`training.n_iters`, with two log lines every `training.log_freq` steps
(the loss and its score, flow and prior terms: their means with steps a
second, then their standard deviations), the meta pair of checkpoints
every `training.snapshot_freq_for_preemption` steps and after the last,
the numbered pair every `training.snapshot_freq`, and at the preemption
cadence bits/dim of the test split (`eval.enable_bpd`) and a sampling
snapshot with its FID (`training.snapshot_sampling`). `--mode eval` runs
`run_lib.evaluate` on the checkpoint: bits/dim, then sampling rounds into
`<workdir>/eval` and their FID, IS and KID; with `eval.data_mean` the VE
prior is centred at the latent mean of the training split.

The configs: `vp/CIFAR10/indm_nll`, `vp/CIFAR10/indm_fid`,
`ve/CIFAR10/indm` and their 64x64 CelebA counterparts `vp/CELEBA/...` and
`ve/CELEBA/indm`. The data: `cifar-10-batches-py/` (CIFAR-10's python
pickles), `<dataset>.npz` (uint8 NHWC `train` and `test`), or an image
folder `<dataset>/` (`celeba/`, with `train/` and `test/` or `val/`, or
flat and split 95/5; cropped and resized as the reference does, then
cached beside it as `celeba_64.npz`; PNGs are read without PIL, JPEGs
need PIL or that cache) under `config.datadir` (`--set datadir=DIR`; "."
by default), `$INDM_DATA_DIR`, `<datadir>/data` or `./data`, the first
found. With none of them every split is the seeded
synthetic set and a warning says so: a pipeline check, not training on
data.

The log goes to standard output and to `<workdir>/stdout.txt` (train) or
`<workdir>/evaluation_history.txt` (eval); the config is written to
`<workdir>/config.txt`. The command runs the configuration whose TPU
kernels the port has: `model.fused_groupnorm=True` (the score net's
GroupNorm, forward and backward, through kernels 1 and 2) and
`flow.logdet_pallas=True` (the flow's Neumann chain through kernel 7); the
VE net's FIR resampling always runs kernel 9, forward and backward. `--set`
can turn the two switches off. As in the JAX package, `optim.reset` (on in
both configs) starts the score net's optimizer afresh on a resume, and
under VESDE its state is never restored; `--set optim.reset=false` with a
VP config makes a resumed run take the steps of one that did not stop.
Without a card it raises unless `--device cpu` is given, where every
kernel takes its plain version.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from indm_torch import run_lib
from indm_torch.configs import get_config

FORMAT = "%(levelname)s - %(filename)s - %(asctime)s - %(message)s"


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  p.add_argument("--mode", required=True, choices=("train", "eval"))
  p.add_argument("--config", required=True,
                 help="vp/CIFAR10/indm_nll, vp/CIFAR10/indm_fid, "
                      "ve/CIFAR10/indm, or the same under CELEBA")
  p.add_argument("--workdir", required=True)
  p.add_argument("--device", default="cuda")
  p.add_argument("--set", action="append", default=[], metavar="LEAF=VALUE",
                 help="override a config leaf, e.g. training.n_iters=100; "
                      "model.fused_groupnorm and flow.logdet_pallas are on "
                      "unless set here")
  args = p.parse_args(argv)
  config = get_config(args.config)
  config.model.fused_groupnorm = True
  config.flow.logdet_pallas = True
  for item in args.set:
    name, _, value = item.partition("=")
    config.set_dotted(name, value)

  os.makedirs(args.workdir, exist_ok=True)
  with open(os.path.join(args.workdir, "config.txt"), "w") as f:
    f.write("\n".join(f"{k}: {v!r}" for k, v in config.leaves()) + "\n")
  log_name = "stdout.txt" if args.mode == "train" else \
      "evaluation_history.txt"
  handlers = [logging.FileHandler(os.path.join(args.workdir, log_name)),
              logging.StreamHandler(sys.stdout)]
  root = logging.getLogger()
  for h in handlers:
    h.setFormatter(logging.Formatter(FORMAT))
    root.addHandler(h)
  level = root.level
  root.setLevel(logging.INFO)
  try:
    if args.mode == "train":
      return run_lib.train(config, args.workdir, device=args.device)
    return run_lib.evaluate(config, args.workdir, device=args.device,
                            log=logging.info)
  finally:
    for h in handlers:
      root.removeHandler(h)
      h.close()
    root.setLevel(level)


if __name__ == "__main__":
  main()
