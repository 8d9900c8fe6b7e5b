"""Data for the port (counterpart of `indm_tpu/data.py:32-42, 187-201`):
the scalers, and the seeded synthetic training set with its batch
iterator. Loading CIFAR-10 from disk is not ported yet.
"""

import numpy as np


def get_data_scaler(config):
  """[0, 1] -> [-1, 1] when the data is centered."""
  if config.data.centered:
    return lambda x: x * 2.0 - 1.0
  return lambda x: x


def get_data_inverse_scaler(config):
  if config.data.centered:
    return lambda x: (x + 1.0) / 2.0
  return lambda x: x


def synthetic(config, n: int = 512):
  """The training images, uint8 NHWC: smooth seeded random images, the JAX
  package's fallback when no dataset is on disk (the training half of
  `indm_tpu/data.py:_synthetic`)."""
  s = config.data.image_size
  c = config.data.num_channels
  base = np.random.default_rng(1234).normal(size=(n, s // 2 or 1,
                                                  s // 2 or 1, c))
  img = np.repeat(np.repeat(base, 2, axis=1), 2, axis=2)[:, :s, :s]
  return (1 / (1 + np.exp(-img)) * 255).astype(np.uint8)


class TrainBatches:
  """Endless float32 NHWC batches in [0, 1]: a seeded permutation per
  epoch, the remainder dropped, random horizontal flips."""

  def __init__(self, data: np.ndarray, batch_size: int, random_flip: bool,
               seed: int):
    if batch_size > len(data):
      raise ValueError(f"batch {batch_size} exceeds the {len(data)} images")
    self.data = data
    self.batch_size = batch_size
    self.random_flip = random_flip
    self.rng = np.random.default_rng(seed)
    self._order = np.zeros(0, np.int64)

  def __iter__(self):
    return self

  def __next__(self) -> np.ndarray:
    if len(self._order) < self.batch_size:
      self._order = self.rng.permutation(len(self.data))
    idx, self._order = (self._order[:self.batch_size],
                        self._order[self.batch_size:])
    batch = self.data[idx].astype(np.float32) / 255.0
    if self.random_flip:
      flips = self.rng.random(len(idx)) < 0.5
      batch[flips] = batch[flips, :, ::-1]
    return batch
