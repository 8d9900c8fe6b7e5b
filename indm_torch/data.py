"""Data for the port (counterpart of `indm_tpu/data.py:32-42, 187-204,
314`): the scalers, the seeded synthetic training and test splits, the
training batch iterator with its state for checkpoints, and the test
split's epoch-start pass for the bits/dim sections. Loading CIFAR-10 from
disk is not ported yet, so every dataset is the synthetic one.
"""

from typing import Iterator

import numpy as np
import torch


def get_data_scaler(config):
  """[0, 1] -> [-1, 1] when the data is centered."""
  if config.data.centered:
    return lambda x: x * 2.0 - 1.0
  return lambda x: x


def get_data_inverse_scaler(config):
  if config.data.centered:
    return lambda x: (x + 1.0) / 2.0
  return lambda x: x


def synthetic(config, n_train: int = 512, n_test: int = 128):
  """(train, test) uint8 NHWC: smooth seeded random images, the JAX
  package's fallback when no dataset is on disk
  (`indm_tpu/data.py:_synthetic`): both splits from one
  `default_rng(1234)`, the test split its second draw."""
  s = config.data.image_size
  c = config.data.num_channels
  rng = np.random.default_rng(1234)

  def make(n):
    base = rng.normal(size=(n, s // 2 or 1, s // 2 or 1, c))
    img = np.repeat(np.repeat(base, 2, axis=1), 2, axis=2)[:, :s, :s]
    return (1 / (1 + np.exp(-img)) * 255).astype(np.uint8)

  return make(n_train), make(n_test)


def is_synthetic(config) -> bool:
  """Whether `config.data.dataset` is the seeded synthetic set
  (`indm_tpu/data.py:is_synthetic`). The port loads no dataset from disk
  yet, so it always is."""
  return True


class EvalBatches:
  """The test split in batches of `batch_size`, as float32 NHWC in
  [0, 1]: `epoch()` starts again from image 0 on every call, in order,
  with no flip, and wraps around at the end (the JAX package's
  `EpochIterator.epoch`), so that every bits/dim section sees the same
  images in the same order."""

  def __init__(self, data: np.ndarray, batch_size: int):
    self.data = data
    self.batch_size = batch_size

  def epoch(self) -> Iterator[np.ndarray]:
    i, n = 0, len(self.data)
    while True:
      idx = np.arange(i, i + self.batch_size) % n
      yield self.data[idx].astype(np.float32) / 255.0
      i = (i + self.batch_size) % n


def eval_dataset(config) -> EvalBatches:
  """The test split in batches of `eval.batch_size`."""
  return EvalBatches(synthetic(config)[1], config.eval.batch_size)


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

  def state_dict(self) -> dict:
    """The generator's state and the rest of the epoch's permutation."""
    return {"rng": self.rng.bit_generator.state,
            "order": torch.from_numpy(self._order.copy())}

  def load_state_dict(self, state: dict):
    self.rng.bit_generator.state = state["rng"]
    self._order = state["order"].cpu().numpy().astype(np.int64)
