"""The bits/dim harness (PyTorch): `get_bpd`, the counterpart of
`indm_tpu/evaluation.py:209-335` (the reference's `evaluation.py:388-495`).

Its sections: the NELBO `eval.num_nelbo` times, "NLL wrong" (no residual;
unless `eval.skip_nll_wrong`), "NLL correct" (with the residual), and
"NLL correct w/ eps = training eps" (when `training.truncation_time` is not
1e-5). Every section restarts the test split from its first image
(`eval_ds.epoch()`), so that all see the same images in the same order; the
dequantisation noise comes from one `default_rng(step)` across them. FID
and IS are not ported.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

import numpy as np
import torch

from indm_torch import data as data_lib

# the JAX package's fold_in values of each section's batches: NELBO pass k,
# batch i takes k * 10000 + i; the NLL sections add i to these
NELBO_PASS_KEYS = 10_000
NLL_WRONG_KEY, NLL_CORRECT_KEY, NLL_TRAIN_EPS_KEY = (5_000_000, 6_000_000,
                                                      7_000_000)


def seeded_draws(step: int, key: int, batch: torch.Tensor) -> dict:
  """The keyword arguments of one batch's `nelbo_fn` or `nll_fn`: a torch
  generator on the batch's device seeded from (step, key), where the JAX
  package takes `fold_in(PRNGKey(step), key)`."""
  return {"generator": torch.Generator(device=batch.device).manual_seed(
      step * 100_000_000 + key)}


def get_bpd(config, eval_ds, scaler, nelbo_fn, nll_fn, score_fn,
            flow_forward_fn, step: int = 0, eval: bool = False,
            device="cuda", log: Callable = logging.info,
            draws: Optional[Callable] = None) -> dict:
  """Run the sections on `eval_ds` (an `EvalBatches`) and return their
  mean bits/dim by name ("nelbo", "nelbo_residual", "nll_wrong",
  "nll_correct", "nll_correct_train_eps"), with each section's images
  (`{name}_images`), host seconds (`{name}_seconds`) and, for the NLL
  sections, function evaluations (`{name}_nfe`). `nelbo_fn` and `nll_fn` are
  `likelihood.get_elbo_fn` and `get_likelihood_fn`'s closures; each batch's
  draws are `draws(step, key, batch)` (default `seeded_draws`), handed to
  them as keyword arguments. At `eval` the count is `eval.num_test_data`,
  in training 10000 and a tenth of it for the NLL sections; the synthetic
  set caps it, and at `eval` a smaller real dataset raises."""
  draws = draws or seeded_draws
  num_data = config.eval.num_test_data if eval else 10000
  batch_size = config.eval.batch_size
  ds_size = len(eval_ds.data)
  if ds_size < num_data:
    synthetic = data_lib.is_synthetic(config)
    if eval and not synthetic:
      raise ValueError(
          f"eval dataset has {ds_size} images but "
          f"eval.num_test_data={num_data}; refusing to report a partial "
          "test-set bpd")
    logging.warning("bpd harness: %s dataset (%d images) < num_data=%d; "
                    "capping.", "SYNTHETIC" if synthetic else "on-disk",
                    ds_size, num_data)
    num_data = ds_size
  np_rng = np.random.default_rng(step)

  def batches(n):
    it = eval_ds.epoch()
    for i in range(max((n - 1) // batch_size + 1, 1)):
      b = next(it)
      b = (255.0 * b + np_rng.random(b.shape, dtype=np.float32)) / 256.0
      b = torch.from_numpy(np.ascontiguousarray(
          scaler(b).transpose(0, 3, 1, 2))).to(device)
      yield i, b

  t_nelbo = time.time()
  pass_means, pass_means_res = [], []
  for k in range(config.eval.num_nelbo):
    nelbos, nelbos_res = [], []
    for i, b in batches(num_data):
      ne, ne_res = nelbo_fn(score_fn, flow_forward_fn, b,
                            **draws(step, k * NELBO_PASS_KEYS + i, b))
      nelbos.append(ne.cpu().numpy())
      nelbos_res.append(ne_res.cpu().numpy())
    nelbos = np.concatenate(nelbos)
    nelbos_res = np.concatenate(nelbos_res)
    log(f"step: {step}, num samples: {len(nelbos)}, mean nelbo bpd: "
        f"{nelbos.mean():.5e}, std nelbo bpd: {nelbos.std():.5e}")
    log(f"step: {step}, num samples: {len(nelbos_res)}, mean "
        f"nelbo_residual bpd: {nelbos_res.mean():.5e}, std nelbo_residual "
        f"bpd: {nelbos_res.std():.5e}")
    pass_means.append(float(nelbos.mean()))
    pass_means_res.append(float(nelbos_res.mean()))
  nelbo = float(np.mean(pass_means))
  nelbo_res = float(np.mean(pass_means_res))
  log(f"step: {step}, average nelbo bpd out of {len(pass_means)} "
      f"evaluations: {nelbo:.5e}")
  log(f"step: {step}, average nelbo residual bpd out of "
      f"{len(pass_means_res)} evaluations: {nelbo_res:.5e}")
  log(f"step: {step}, [NELBO x{config.eval.num_nelbo}] section wall-clock: "
      f"{time.time() - t_nelbo:.1f}s")
  results = {"nelbo": nelbo, "nelbo_residual": nelbo_res,
             "nelbo_images": len(nelbos),
             "nelbo_seconds": time.time() - t_nelbo}

  nll_num_data = num_data if eval else max(num_data // 10, 1)
  # eval.truncation_time = -1 means 1e-5 (`evaluation.py:437-440`)
  eps_bpd = (1e-5 if config.eval.truncation_time == -1.0
             else config.eval.truncation_time)

  def nll_section(name, tag, residual, eps, salt):
    t_section = time.time()
    bpds, nfe_total = [], 0
    for i, b in batches(nll_num_data):
      bpd, _, nfe = nll_fn(score_fn, flow_forward_fn, b, residual=residual,
                           eps_bpd=eps, **draws(step, salt + i, b))
      bpds.append(bpd.cpu().numpy())
      nfe_total += int(nfe)
      if eval:
        cat = np.concatenate(bpds)
        log(f"step: {step}, [{tag}] num samples: {len(cat)}, mean nll bpd: "
            f"{cat.mean():.5e}, std nll bpd: {cat.std():.5e}")
    bpds = np.concatenate(bpds)
    log(f"step: {step}, [{tag}] num samples: {len(bpds)}, mean nll bpd: "
        f"{bpds.mean():.5e}, std nll bpd: {bpds.std():.5e} (nfe "
        f"{nfe_total})")
    seconds = time.time() - t_section
    log(f"step: {step}, [{tag}] section wall-clock: {seconds:.1f}s")
    results.update({name: float(bpds.mean()), f"{name}_images": len(bpds),
                    f"{name}_nfe": nfe_total, f"{name}_seconds": seconds})

  if not config.eval.skip_nll_wrong:
    nll_section("nll_wrong", f"NLL WRONG w/ eps={eps_bpd:.1e}", False,
                eps_bpd, NLL_WRONG_KEY)
  nll_section("nll_correct", f"NLL CORRECT w/ eps={eps_bpd:.1e}", True,
              eps_bpd, NLL_CORRECT_KEY)
  if config.training.truncation_time != 1e-5:
    nll_section("nll_correct_train_eps", "NLL CORRECT w/ eps=eps", True,
                config.training.truncation_time, NLL_TRAIN_EPS_KEY)
  return results
