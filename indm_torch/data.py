"""Data for the port (counterpart of `indm_tpu/data.py:32-241,
250-341`): the scalers, the datasets on disk (CIFAR-10's python pickles,
`<dataset>.npz`, image folders) with the seeded synthetic fallback, the
training batch iterator with its state for checkpoints, and the test
split's epoch-start pass for the bits/dim sections.

Where data is looked for (`_search_dirs`): `config.datadir`,
`$INDM_DATA_DIR`, `<datadir>/data` and `./data`, in that order (the JAX
package's list, less its one fixed absolute directory). In each, a
`cifar-10-batches-py/` folder (for CIFAR10), a `<dataset>.npz` with uint8
NHWC `train` and `test` arrays, or CelebA's image folder `celeba/`,
whose processed arrays are cached beside it as `<dataset>_<size>.npz`
(`celeba_64.npz`), the JAX package's cache, read by either. With nothing on disk every split is the seeded
synthetic one, with the JAX package's warning.

Image folders are read without PIL where they hold PNGs
(`image_io.read_png`) and resized with `image_io.resize_bicubic`, Pillow's
8-bit bicubic bit for bit; other formats (CelebA ships JPEGs) need PIL,
imported in the loader where it is installed, or the cache file written
on a machine that has it.
"""

import logging
import os
import pickle
from typing import Iterator, Tuple

import numpy as np
import torch

from indm_torch import image_io


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


# ---- image folders (`indm_tpu/data.py:80-185`) ----


def _central_crop(img, size: int):
  h, w = img.shape[:2]
  top, left = (h - size) // 2, (w - size) // 2
  return img[top:top + size, left:left + size]


def _resize_small(img: np.ndarray, size: int) -> np.ndarray:
  """Resize keeping the aspect so that the smaller side is `size`, the
  other side floored (`int(h * ratio)`)."""
  h, w = img.shape[:2]
  ratio = size / min(h, w)
  return image_io.resize_bicubic(img, int(h * ratio), int(w * ratio))


def _preprocess_image(config, img: np.ndarray) -> np.ndarray:
  """The reference's CelebA resize: the centre 140, the smaller side to
  `data.image_size`, the centre square. Image folders of other datasets
  raise: no shipped config reads one."""
  ds = config.data.dataset.upper()
  if ds != "CELEBA":
    raise NotImplementedError(
        f"image folders of {config.data.dataset} are not read by the port; "
        f"give the arrays as {ds.lower()}.npz")
  size = config.data.image_size
  img = _central_crop(img, 140)
  img = _resize_small(img, size)
  return _central_crop(img, size)


_IMG_EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")


def _list_images(folder: str):
  out = []
  for root, _, files in os.walk(folder):
    for f in files:
      if f.lower().endswith(_IMG_EXTS):
        out.append(os.path.join(root, f))
  return sorted(out)


def _cache_path(config, dirname: str) -> str:
  return os.path.join(
      dirname, f"{config.data.dataset.lower()}_{config.data.image_size}.npz")


def _decode(path: str, cache: str) -> np.ndarray:
  """uint8 [H, W, 3] of one image file: PNGs without PIL, other files (and
  PNGs the reader does not take) with PIL where it is installed."""
  if path.lower().endswith(".png"):
    try:
      return image_io.read_png(path)
    except image_io.UnsupportedPNG:
      pass
  try:
    from PIL import Image
  except ImportError:
    raise RuntimeError(
        f"{path} needs PIL to decode, and PIL is not installed here. Load "
        f"the folder once on a machine with PIL (this package or the JAX "
        f"package): it writes {cache}, which is read here without PIL"
    ) from None
  with Image.open(path) as im:
    return np.asarray(im.convert("RGB"))


def _load_image_folder(config, dirname: str):
  """(train, test) uint8 NHWC from the image folder of the dataset under
  `dirname` (`_image_folders`), or None where there is none. The
  `<dataset>_<size>.npz` cache beside it is read where it exists, else
  written after the folder is read: `train/` and the first of `test/`,
  `val/`, `valid/` where there is `train/` (no test folder: the last
  training image), else the sorted files split 95/5, each image
  `_preprocess_image`d. A folder that holds no image raises (the JAX
  package falls back to the synthetic set there)."""
  base = next((f for f in _image_folders(config, dirname)
               if os.path.isdir(f)), None)
  if base is None:
    return None
  cache = _cache_path(config, dirname)
  if os.path.exists(cache):
    with np.load(cache) as z:
      return z["train"], z["test"]

  def load_all(files):
    return np.stack([_preprocess_image(config, _decode(f, cache))
                     for f in files]).astype(np.uint8)

  train_dir = os.path.join(base, "train")
  test_dir = next((os.path.join(base, n) for n in ("test", "val", "valid")
                   if os.path.isdir(os.path.join(base, n))), None)
  if os.path.isdir(train_dir):
    train_files = _list_images(train_dir)
    test_files = _list_images(test_dir) if test_dir else train_files[-1:]
  else:
    files = _list_images(base)
    n_test = max(1, len(files) // 20)
    train_files, test_files = files[:-n_test], files[-n_test:]
  if not train_files:
    raise ValueError(f"{base} holds no training image ({', '.join(_IMG_EXTS)})")
  train, test = load_all(train_files), load_all(test_files)
  try:
    np.savez_compressed(cache, train=train, test=test)
  except OSError:
    logging.warning("could not write dataset cache %s", cache)
  return train, test


def _image_folders(config, dirname: str):
  ds = config.data.dataset
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
    if os.path.exists(_cache_path(config, d)):
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
    out = _load_image_folder(config, d)
    if out is not None:
      return out
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
