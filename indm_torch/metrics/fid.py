"""FID, KID and Inception Score from Inception features.

Counterpart of `indm_tpu/metrics/fid.py`: the Frechet distance through
SciPy's matrix square root on the host (as the reference computes it) or
through a Newton-Schulz iteration on the device, the polynomial-kernel
KID, and the classifier score from logits.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def compute_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
  """(mu, sigma) of [N, D] features."""
  return np.mean(features, axis=0), np.cov(features, rowvar=False)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
  """FID between two Gaussians (`cleanfid/fid.py:27-81`): when the square
  root of sigma1 sigma2 is not finite, once more with eps on both
  diagonals; an imaginary part beyond 1e-3 on the root's diagonal
  raises."""
  import scipy.linalg

  mu1 = np.atleast_1d(np.asarray(mu1, np.float64))
  mu2 = np.atleast_1d(np.asarray(mu2, np.float64))
  sigma1 = np.atleast_2d(np.asarray(sigma1, np.float64))
  sigma2 = np.atleast_2d(np.asarray(sigma2, np.float64))
  diff = mu1 - mu2
  covmean = scipy.linalg.sqrtm(sigma1.dot(sigma2))
  if not np.isfinite(covmean).all():
    offset = np.eye(sigma1.shape[0]) * eps
    covmean = scipy.linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
  if np.iscomplexobj(covmean):
    if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
      m = np.max(np.abs(covmean.imag))
      raise ValueError(f"Imaginary component {m}")
    covmean = covmean.real
  return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
               - 2 * np.trace(covmean))


def frechet_distance_newton_schulz(mu1, sigma1, mu2, sigma2,
                                   num_iters: int = 30, device="cuda",
                                   dtype=torch.float64) -> torch.Tensor:
  """FID with the square root of sigma1 sigma2 by `num_iters` coupled
  Newton-Schulz steps on `device` (a 0-d tensor there)."""
  mu1, mu2, s1, s2 = (torch.as_tensor(np.asarray(a), dtype=dtype,
                                      device=device)
                      for a in (mu1, mu2, sigma1, sigma2))
  a = s1 @ s2
  eye = torch.eye(a.shape[0], dtype=dtype, device=device)
  norm = torch.linalg.matrix_norm(a)
  y, z = a / norm, eye
  for _ in range(num_iters):
    t = 0.5 * (3.0 * eye - z @ y)
    y, z = y @ t, t @ z
  diff = mu1 - mu2
  return (diff @ diff + torch.trace(s1) + torch.trace(s2)
          - 2.0 * torch.trace(y * torch.sqrt(norm)))


def kernel_distance(feats1: np.ndarray, feats2: np.ndarray,
                    num_subsets: int = 100, max_subset_size: int = 1000,
                    seed: int = 0) -> float:
  """KID with the cubic polynomial kernel (`cleanfid/fid.py:83-98`), the
  subsets drawn from `default_rng(seed)`."""
  n = feats1.shape[1]
  m = min(min(feats1.shape[0], feats2.shape[0]), max_subset_size)
  rng = np.random.default_rng(seed)
  t = 0.0
  for _ in range(num_subsets):
    x = feats2[rng.choice(feats2.shape[0], m, replace=False)]
    y = feats1[rng.choice(feats1.shape[0], m, replace=False)]
    a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
    b = (x @ y.T / n + 1) ** 3
    t += (a.sum() - np.trace(a)) / (m - 1) - b.sum() * 2 / m
  return float(t / num_subsets / m)


def inception_score(logits: np.ndarray, splits: int = 1) -> float:
  """The classifier score exp(E KL(p(y|x) || p(y))) from logits, the
  softmax in float32 (`evaluation.py:274-337`)."""
  probs = torch.softmax(torch.as_tensor(np.asarray(logits, np.float32)),
                        dim=-1).numpy()
  n = probs.shape[0]
  scores = []
  for i in range(splits):
    part = probs[i * n // splits:(i + 1) * n // splits]
    kl = part * (np.log(part + 1e-12)
                 - np.log(np.mean(part, axis=0, keepdims=True) + 1e-12))
    scores.append(np.exp(np.mean(np.sum(kl, axis=1))))
  return float(np.mean(scores))
