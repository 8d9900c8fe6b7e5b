"""Evaluation (PyTorch): FID/IS/KID over sampled rounds, and the bits/dim
harness `get_bpd`; the counterpart of `indm_tpu/evaluation.py`.

FID (`indm_tpu/evaluation.py:43-186`): each round's uint8 samples are
resized to 299 as clean-fid resizes them (`clean_resize`: PIL's float
bicubic, rebuilt as two weight matrices applied on the device; no PIL),
run through the port's InceptionV3 (`indm_torch.metrics.inception`) on
the device, cached per round in `latents_{r}.npz`, and scored against the
dataset's statistics (`dataset_statistics`: `{dataset}_fid_stats_{mode}.npz`
under `config.datadir`, the repository's `cifar10_fid_stats_clean.npz` with
`datadir = "."`), with KID where a stats file holds raw `pool_3` features;
the report goes to `report_all.npz`.

The bits/dim sections: the NELBO `eval.num_nelbo` times, "NLL wrong" (no
residual; unless `eval.skip_nll_wrong`), "NLL correct" (with the
residual), and "NLL correct w/ eps = training eps" (when
`training.truncation_time` is not 1e-5; `indm_tpu/evaluation.py:209-335`,
the reference's `evaluation.py:388-495`). Every section restarts the test
split from its first image (`eval_ds.epoch()`), so that all see the same
images in the same order; the dequantisation noise comes from one
`default_rng(step)` across them.
"""

from __future__ import annotations

import functools
import logging
import os
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from indm_torch import data as data_lib
from indm_torch.metrics import inception as inception_lib
from indm_torch.metrics.fid import (compute_statistics, frechet_distance,
                                    inception_score, kernel_distance)


def _bicubic(x: np.ndarray) -> np.ndarray:
  """PIL's bicubic kernel, a = -0.5."""
  a = -0.5
  x = np.abs(x)
  return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                  np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


@functools.lru_cache(maxsize=8)
def pil_bicubic_matrix(in_size: int, out_size: int) -> np.ndarray:
  """[out_size, in_size] float64 weights of PIL's resampling of one axis
  (`precompute_coeffs` in Pillow's Resample.c): support 2 widened by the
  scale when shrinking, each output's window rounded and clipped to the
  input, its weights normalised to sum 1. Cached, read-only."""
  scale = in_size / out_size
  filterscale = max(scale, 1.0)
  support = 2.0 * filterscale
  w = np.zeros((out_size, in_size))
  for xx in range(out_size):
    center = (xx + 0.5) * scale
    xmin = max(int(center - support + 0.5), 0)
    xmax = min(int(center + support + 0.5), in_size)
    k = _bicubic((np.arange(xmin, xmax) - center + 0.5) / filterscale)
    total = k.sum()
    w[xx, xmin:xmax] = k / total if total != 0.0 else k
  w.flags.writeable = False
  return w


def clean_resize(images_u8, size: int = inception_lib.SIZE,
                 device="cuda") -> torch.Tensor:
  """clean-fid's resize (`cleanfid/resize.py:20-67`), PIL's float bicubic
  per channel, of uint8 [N, H, W, C] images: the horizontal pass, rounded
  to float32, then the vertical pass, each a float64 product with
  `pil_bicubic_matrix` on `device`, rounded to float32 as Pillow stores
  it. Returns float32 [N, C, size, size] on the 0-255 scale."""
  x = torch.as_tensor(np.asarray(images_u8)).to(device)
  n, h, w, c = x.shape
  wh = torch.tensor(pil_bicubic_matrix(w, size), device=device)
  wv = torch.tensor(pil_bicubic_matrix(h, size), device=device)
  x = x.permute(0, 3, 1, 2).to(torch.float64)
  x = (x @ wh.T).to(torch.float32).to(torch.float64)
  return (wv @ x).to(torch.float32)


def get_inception_features(images_u8, model=None, mode: str = "clean",
                           batch_size: int = 64, device="cuda"
                           ) -> Tuple[np.ndarray, np.ndarray]:
  """(pool3 [N, 2048], logits [N, 1008]) of uint8 [N, H, W, C] samples:
  `mode` "clean" resizes with `clean_resize` (the extractor's bilinear
  resize is then the identity), any other mode hands [0, 1] images to the
  extractor's bilinear resize. `model` defaults to `load_inception()`."""
  if model is None:
    model = inception_lib.load_inception(device=device)
  extract = inception_lib.feature_extractor(model, batch_size, device)
  pools, logits = [], []
  for i in range(0, len(images_u8), batch_size):
    chunk = images_u8[i:i + batch_size]
    if mode == "clean":
      x = (clean_resize(chunk, device=device) / 255.0).permute(0, 2, 3, 1)
    else:
      x = torch.as_tensor(np.asarray(chunk, np.float32) / 255.0)
    p, l = extract(x)
    pools.append(p)
    logits.append(l)
  return np.concatenate(pools), np.concatenate(logits)


def dataset_statistics(config, assetdir: Optional[str], model=None,
                       mode: str = "clean", device="cuda"):
  """The real data's (mu, sigma, path): from `{assetdir}/{name}_stats.npz`,
  `{assetdir}/stats/{name}_stats.npz` or
  `{config.datadir}/{name}_fid_stats_{mode}.npz`, the first there (its
  `mu` and `sigma`, or the statistics of its raw `pool_3` features); else
  computed from the training split (the port's seeded synthetic images)
  and cached at the last of those paths."""
  name = config.data.dataset.lower()
  candidates = []
  if assetdir:
    candidates += [os.path.join(assetdir, f"{name}_stats.npz"),
                   os.path.join(assetdir, "stats", f"{name}_stats.npz")]
  candidates.append(os.path.join(config.datadir,
                                 f"{name}_fid_stats_{mode}.npz"))
  for path in candidates:
    if os.path.exists(path):
      with np.load(path) as z:
        if "mu" in z:
          return z["mu"], z["sigma"], path
        if "pool_3" in z:
          mu, sigma = compute_statistics(z["pool_3"])
          return mu, sigma, path
  logging.info("computing dataset FID statistics (cached afterwards)...")
  feats, _ = get_inception_features(data_lib.synthetic(config)[0], model,
                                    mode, device=device)
  mu, sigma = compute_statistics(feats)
  cache = candidates[-1]
  os.makedirs(os.path.dirname(cache) or ".", exist_ok=True)
  np.savez_compressed(cache, mu=mu, sigma=sigma)
  return mu, sigma, cache


def _raw_real_features(config, assetdir) -> Optional[np.ndarray]:
  """The raw real `pool_3` features of a score_sde-style stats file under
  `assetdir`, or None."""
  if not assetdir:
    return None
  name = config.data.dataset.lower()
  for path in (os.path.join(assetdir, f"{name}_stats.npz"),
               os.path.join(assetdir, "stats", f"{name}_stats.npz")):
    if os.path.exists(path):
      with np.load(path) as z:
        if "pool_3" in z:
          return z["pool_3"]
  return None


def compute_fid_and_is(config, sample_dir: str, assetdir=None,
                       num_samples: Optional[int] = None, model=None,
                       mode: str = "clean", device="cuda",
                       log: Callable = logging.info) -> dict:
  """FID, IS and (with raw real features) KID of the rounds under
  `sample_dir` (`samples_{r}.npz`, the before-flow files left out), their
  features cached per round in `latents_{r}.npz` and read from there when
  present; the first `num_samples` count. The report, {"fid",
  "inception_score", "num_samples", "weights"[, "kid"]} with the weights'
  provenance ("random" for the seeded ones), is written to
  `report_all.npz` and returned, with "sqrtm_seconds" (the host seconds of
  the Frechet distance) beside it. The provenance is `model`'s
  `weights_source`, else `inception.weights_source()`."""
  if model is None:
    model = inception_lib.load_inception(device=device)
  pools, logits = [], []
  for name in sorted(os.listdir(sample_dir)):
    if not (name.startswith("samples_") and name.endswith(".npz")) \
        or "before_flow" in name:
      continue
    lat_path = os.path.join(sample_dir, name.replace("samples_", "latents_"))
    if os.path.exists(lat_path):
      with np.load(lat_path) as z:
        pools.append(z["pool_3"])
        logits.append(z["logits"])
      continue
    with np.load(os.path.join(sample_dir, name)) as z:
      samples = z["samples"]
    p, l = get_inception_features(samples, model, mode, device=device)
    np.savez_compressed(lat_path, pool_3=p, logits=l)
    pools.append(p)
    logits.append(l)
  if not pools:
    raise FileNotFoundError(f"no cached samples under {sample_dir}")
  pools, logits_all = np.concatenate(pools), np.concatenate(logits)
  if num_samples:
    pools, logits_all = pools[:num_samples], logits_all[:num_samples]
  mu_fake, sigma_fake = compute_statistics(pools)
  mu_real, sigma_real, stats_src = dataset_statistics(config, assetdir,
                                                      model, mode, device)
  t0 = time.perf_counter()
  fid = frechet_distance(mu_fake, sigma_fake, mu_real, sigma_real)
  sqrtm_seconds = time.perf_counter() - t0
  report = {"fid": fid, "inception_score": inception_score(logits_all),
            "num_samples": len(pools),
            "weights": getattr(model, "weights_source", None)
            or inception_lib.weights_source()}
  real_feats = _raw_real_features(config, assetdir)
  if real_feats is not None:
    report["kid"] = kernel_distance(pools, real_feats)
  np.savez_compressed(os.path.join(sample_dir, "report_all.npz"), **report)
  log(f"FID: {fid:.4f}, IS: {report['inception_score']:.4f}, KID: "
      f"{report.get('kid', 'n/a')} (N={len(pools)}, stats={stats_src}, "
      f"weights={report['weights']})")
  return {**report, "sqrtm_seconds": sqrtm_seconds}


def fid_folder(config, folder: str, assetdir=None, model=None,
               mode: str = "clean", batch_size: int = 64,
               device="cuda") -> float:
  """FID of a folder of images (PNG, JPG or .npy, HWC uint8) against the
  dataset statistics (`cleanfid.fid.fid_folder`, `cleanfid/fid.py:
  228-277`). PIL decodes the image files; nothing else here needs it."""
  files = sorted(os.path.join(folder, f) for f in os.listdir(folder)
                 if f.lower().endswith((".png", ".jpg", ".jpeg", ".npy")))
  if not files:
    raise FileNotFoundError(f"no images under {folder}")
  imgs = []
  for f in files:
    if f.endswith(".npy"):
      imgs.append(np.load(f))
    else:
      from PIL import Image
      imgs.append(np.asarray(Image.open(f).convert("RGB")))
  if model is None:
    model = inception_lib.load_inception(device=device)
  feats, _ = get_inception_features(np.stack(imgs).astype(np.uint8), model,
                                    mode, batch_size, device)
  mu, sigma = compute_statistics(feats)
  mu_r, sigma_r, _ = dataset_statistics(config, assetdir, model, mode,
                                        device)
  return frechet_distance(mu, sigma, mu_r, sigma_r)


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
