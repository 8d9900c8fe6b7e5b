"""Data for the port (counterpart of `indm_tpu/data.py:32-78, 187-241,
250-341`): the scalers, the datasets on disk (CIFAR-10's python pickles or
`<dataset>.npz`) with the seeded synthetic fallback, the training batch
iterator with its state for checkpoints, and the test split's epoch-start
pass for the bits/dim sections.

Where data is looked for (`_search_dirs`): `config.datadir`,
`$INDM_DATA_DIR`, `<datadir>/data` and `./data`, in that order (the JAX
package's list, less its one fixed absolute directory). In each, a
`cifar-10-batches-py/` folder (for CIFAR10) or a `<dataset>.npz` with
uint8 NHWC `train` and `test` arrays. Image folders (CelebA, LSUN) are not
ported yet: where one is found, loading raises. With nothing on disk every
split is the seeded synthetic one, with the JAX package's warning.
"""

import logging
import os
import pickle
from typing import Iterator, Tuple

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


def _search_dirs(config):
  dirs = [config.datadir, os.environ.get("INDM_DATA_DIR", ""),
          os.path.join(config.datadir, "data"), "./data"]
  return [d for d in dirs if d]


def _load_cifar10(dirname: str):
  """(train, test) uint8 NHWC from `<dirname>/cifar-10-batches-py/`
  (`data_batch_1` .. `_5` and `test_batch`), or None."""
  base = os.path.join(dirname, "cifar-10-batches-py")
  if not os.path.isdir(base):
    return None

  def load_batch(name):
    with open(os.path.join(base, name), "rb") as f:
      d = pickle.load(f, encoding="bytes")
    return d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)

  train = np.concatenate([load_batch(f"data_batch_{i}")
                          for i in range(1, 6)])
  test = load_batch("test_batch")
  return train.astype(np.uint8), test.astype(np.uint8)


def _load_npz(dirname: str, dataset: str):
  for name in (f"{dataset.lower()}.npz", f"{dataset}.npz"):
    path = os.path.join(dirname, name)
    if os.path.exists(path):
      with np.load(path) as z:
        return z["train"].astype(np.uint8), z["test"].astype(np.uint8)
  return None


def _image_folders(config, dirname: str):
  ds = config.data.dataset
  if ds.upper() == "LSUN" and config.data.get("category"):
    return [os.path.join(dirname, "lsun", config.data.category),
            os.path.join(dirname, "LSUN", config.data.category)]
  return [os.path.join(dirname, ds), os.path.join(dirname, ds.lower())]


def is_synthetic(config) -> bool:
  """True when no source on disk exists for `config.data.dataset`, so
  that `load_arrays` returns the synthetic set (existence checks only, as
  `indm_tpu/data.py:is_synthetic`)."""
  ds = config.data.dataset
  for d in _search_dirs(config):
    if ds.upper() == "CIFAR10" and os.path.isdir(
        os.path.join(d, "cifar-10-batches-py")):
      return False
    if any(os.path.exists(os.path.join(d, n))
           for n in (f"{ds.lower()}.npz", f"{ds}.npz")):
      return False
    if any(os.path.isdir(f) for f in _image_folders(config, d)):
      return False
    if os.path.exists(os.path.join(
        d, f"{ds.lower()}_{config.data.image_size}.npz")):
      return False
  return True


def load_arrays(config) -> Tuple[np.ndarray, np.ndarray]:
  """(train, test) uint8 NHWC arrays of `config.data.dataset`: the first
  source found in the search directories, else the synthetic set."""
  ds = config.data.dataset.upper()
  for d in _search_dirs(config):
    if ds == "CIFAR10":
      out = _load_cifar10(d)
      if out is not None:
        return out
    out = _load_npz(d, ds)
    if out is not None:
      return out
    folder = next((f for f in _image_folders(config, d) if os.path.isdir(f)),
                  None)
    if folder is not None:
      raise NotImplementedError(
          f"{folder} is an image folder, which the port does not load yet; "
          f"convert it to {ds.lower()}.npz (uint8 NHWC 'train' and 'test')")
  logging.warning(
      "No on-disk dataset found for %s; using deterministic synthetic data "
      "(seeded). Place cifar-10-batches-py/ or %s.npz under datadir for "
      "real training.", config.data.dataset, config.data.dataset.lower())
  return synthetic(config)


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
  return EvalBatches(load_arrays(config)[1], config.eval.batch_size)


_U64 = np.uint64


def _splitmix64(x: np.ndarray) -> np.ndarray:
  """splitmix64 of a uint64 array, wrapping as C's uint64_t does."""
  x = x + _U64(0x9E3779B97F4A7C15)
  x = (x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
  x = (x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)
  return x ^ (x >> _U64(31))


def flip_draws(seed: int, n: int) -> np.ndarray:
  """[n] bools: whether the native loader flips example b of the batch
  with stream id `seed` (`indm_tpu/native/dataloader.cpp:26-72`): the low
  bit of the first draw of `Rng(splitmix64(seed) ^ b)`, whose state starts
  at splitmix64 of its seed."""
  base = _splitmix64(np.array([seed & (2 ** 64 - 1)], _U64))
  state = _splitmix64(base ^ np.arange(n, dtype=_U64))
  return (_splitmix64(state) & _U64(1)).astype(bool)


# the native loader's scale, 1.0f / 255.0f, rounded as float32
_INV_255 = np.float32(1) / np.float32(255)


class TrainBatches:
  """Endless float32 NHWC batches in [0, 1], the JAX package's training
  batches bit for bit (`EpochIterator` with the native loader): a
  permutation of the images per epoch from `default_rng(seed)`, the
  remainder dropped; batch j (counted over all epochs) gathered,
  flipped where `flip_draws(j, batch)` says and scaled by 1/255 in
  float32, as the native loader's fill_batch does."""

  def __init__(self, data: np.ndarray, batch_size: int, random_flip: bool,
               seed: int):
    if batch_size > len(data):
      raise ValueError(f"batch {batch_size} exceeds the {len(data)} images")
    self.data = data
    self.batch_size = batch_size
    self.random_flip = random_flip
    self.rng = np.random.default_rng(seed)
    self.batch_seed = 0
    self._order = np.zeros(0, np.int64)

  def __iter__(self):
    return self

  def __next__(self) -> np.ndarray:
    if len(self._order) < self.batch_size:
      self._order = self.rng.permutation(len(self.data))
    idx, self._order = (self._order[:self.batch_size],
                        self._order[self.batch_size:])
    batch = self.data[idx].astype(np.float32) * _INV_255
    if self.random_flip:
      flips = flip_draws(self.batch_seed, len(idx))
      batch[flips] = batch[flips, :, ::-1]
    self.batch_seed += 1
    return batch

  def state_dict(self) -> dict:
    """The generator's state, the rest of the epoch's permutation and the
    count of batches drawn."""
    return {"rng": self.rng.bit_generator.state,
            "order": torch.from_numpy(self._order.copy()),
            "batch_seed": self.batch_seed}

  def load_state_dict(self, state: dict):
    self.rng.bit_generator.state = state["rng"]
    self._order = state["order"].cpu().numpy().astype(np.int64)
    self.batch_seed = int(state["batch_seed"])
