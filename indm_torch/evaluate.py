"""Evaluate a checkpoint with the port: bits/dim, then sampling and FID
(`run_lib.evaluate`, the counterpart of the JAX package's
`main.py --mode eval`).

  python -m indm_torch.evaluate --workdir runs/train [--device cuda] \
      [--config vp/CIFAR10/indm_fid] [--set eval.enable_sampling=false ...]

The models are read from the work directory's meta checkpoint, the one
`python -m indm_torch.train --workdir` writes (`--set eval.target_ckpt=K`:
the numbered pair K), the score net with its EMA under `eval.score_ema`.
With `eval.enable_bpd` (on by default) the bits/dim sections run on the
synthetic test split, each printing its lines: the NELBO
`eval.num_nelbo` times, "NLL wrong" (unless `eval.skip_nll_wrong`),
"NLL correct", and "NLL correct w/ eps=eps" when
`training.truncation_time` is not 1e-5. With `eval.enable_sampling`
`eval.num_samples` images are sampled in rounds of `sampling.batch_size`
into `<workdir>/eval`, then scored: the line "FID: ..., IS: ..., KID: ...
(N=..., stats=..., weights=...)" gives FID and IS, KID where the
statistics hold raw features (the repository's
`cifar10_fid_stats_clean.npz`, read with `datadir = "."`, holds only mu and
sigma), the image count and the Inception weights' source: the file of
$INDM_INCEPTION_WEIGHTS (a pytorch-fid state_dict or clean-fid's
torchscript archive), or "random", the seeded weights used without one,
whose FID is not comparable to published numbers. The Inception network
runs on the device, the matrix square root of the FID on the host (SciPy).

The command runs the score net's GroupNorm through the port's kernels
(`model.fused_groupnorm=True`): kernel 1 in every score evaluation and
kernel 2 in every divergence's VJP. Without a card it raises unless
`--device cpu` is given, where every kernel takes its plain version.
"""

from __future__ import annotations

import argparse

from indm_torch import run_lib
from indm_torch.configs import get_config


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  p.add_argument("--config", default="vp/CIFAR10/indm_nll")
  p.add_argument("--workdir", required=True)
  p.add_argument("--device", default="cuda")
  p.add_argument("--set", action="append", default=[], metavar="LEAF=VALUE",
                 help="override a config leaf, e.g. eval.num_nelbo=1")
  args = p.parse_args(argv)
  config = get_config(args.config)
  config.model.fused_groupnorm = True
  for item in args.set:
    name, _, value = item.partition("=")
    config.set_dotted(name, value)
  return run_lib.evaluate(config, args.workdir, device=args.device)


if __name__ == "__main__":
  main()
