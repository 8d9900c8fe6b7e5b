"""InceptionV3 (the FID variant), PyTorch, NCHW.

Counterpart of `indm_tpu/metrics/inception.py`: pytorch-fid's network with
the FID modifications (the 3x3 average pools of the A, C and E blocks
exclude the padding; the last E block pools by max), 2048 pool features
and 1008 logits, under pytorch-fid's module names
(`Conv2d_1a_3x3.conv.weight`, `Mixed_7c.branch3x3_2a.bn.running_var`, ...),
so that a pytorch-fid state_dict loads as it is and the JAX package's
`convert_torch_state_dict` reads this module's state_dict.

Weights (`load_inception`): a pytorch-fid state_dict or clean-fid's
torchscript archive of the same network (`inception-2015-12-05.pt`, read
through `torchscript_to_fid_state_dict`), from the path given or
$INDM_INCEPTION_WEIGHTS. The JAX package's own weight file is flax msgpack
and is not read here. With no file the weights are drawn from a seed, with
a warning, and `weights_source()` reports "random": such FID, IS and KID
values are consistent with each other but not comparable to published
ones.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

POOL_DIM = 2048
LOGITS_DIM = 1008
SIZE = 299


class BasicConv2d(nn.Module):
  """Conv (no bias), BatchNorm with eps 1e-3 on its running statistics,
  ReLU."""

  def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
    super().__init__()
    self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding,
                          bias=False)
    self.bn = nn.BatchNorm2d(cout, eps=1e-3)

  def forward(self, x):
    return F.relu(self.bn(self.conv(x)))


def _avg_pool_exc_pad(x):
  return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):

  def __init__(self, cin: int, pool_features: int):
    super().__init__()
    self.branch1x1 = BasicConv2d(cin, 64, 1)
    self.branch5x5_1 = BasicConv2d(cin, 48, 1)
    self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
    self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
    self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
    self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
    self.branch_pool = BasicConv2d(cin, pool_features, 1)

  def forward(self, x):
    b5 = self.branch5x5_2(self.branch5x5_1(x))
    b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
    bp = self.branch_pool(_avg_pool_exc_pad(x))
    return torch.cat([self.branch1x1(x), b5, b3, bp], dim=1)


class InceptionB(nn.Module):

  def __init__(self, cin: int):
    super().__init__()
    self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
    self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
    self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
    self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

  def forward(self, x):
    bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
    return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)],
                     dim=1)


class InceptionC(nn.Module):

  def __init__(self, cin: int, c7: int):
    super().__init__()
    self.branch1x1 = BasicConv2d(cin, 192, 1)
    self.branch7x7_1 = BasicConv2d(cin, c7, 1)
    self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
    self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
    self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
    self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
    self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
    self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
    self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
    self.branch_pool = BasicConv2d(cin, 192, 1)

  def forward(self, x):
    b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
    bd = x
    for i in range(1, 6):
      bd = getattr(self, f"branch7x7dbl_{i}")(bd)
    bp = self.branch_pool(_avg_pool_exc_pad(x))
    return torch.cat([self.branch1x1(x), b7, bd, bp], dim=1)


class InceptionD(nn.Module):

  def __init__(self, cin: int):
    super().__init__()
    self.branch3x3_1 = BasicConv2d(cin, 192, 1)
    self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
    self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
    self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
    self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
    self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

  def forward(self, x):
    b3 = self.branch3x3_2(self.branch3x3_1(x))
    b7 = x
    for i in range(1, 5):
      b7 = getattr(self, f"branch7x7x3_{i}")(b7)
    return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionE(nn.Module):
  """`pool_type` "avg" (Mixed_7b) or "max" (Mixed_7c, the FID
  modification)."""

  def __init__(self, cin: int, pool_type: str = "avg"):
    super().__init__()
    self.pool_type = pool_type
    self.branch1x1 = BasicConv2d(cin, 320, 1)
    self.branch3x3_1 = BasicConv2d(cin, 384, 1)
    self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
    self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
    self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
    self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
    self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
    self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
    self.branch_pool = BasicConv2d(cin, 192, 1)

  def forward(self, x):
    b3 = self.branch3x3_1(x)
    b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
    bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
    bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                   dim=1)
    bp = (_avg_pool_exc_pad(x) if self.pool_type == "avg"
          else F.max_pool2d(x, 3, stride=1, padding=1))
    return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)],
                     dim=1)


class InceptionV3FID(nn.Module):
  """(pool features [B, 2048], logits [B, 1008]) of images [B, 3, H, W]
  in [0, 1] (299 x 299 for FID; any size from 75 up runs)."""

  def __init__(self):
    super().__init__()
    self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
    self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
    self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
    self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
    self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
    self.Mixed_5b = InceptionA(192, 32)
    self.Mixed_5c = InceptionA(256, 64)
    self.Mixed_5d = InceptionA(288, 64)
    self.Mixed_6a = InceptionB(288)
    self.Mixed_6b = InceptionC(768, 128)
    self.Mixed_6c = InceptionC(768, 160)
    self.Mixed_6d = InceptionC(768, 160)
    self.Mixed_6e = InceptionC(768, 192)
    self.Mixed_7a = InceptionD(768)
    self.Mixed_7b = InceptionE(1280, "avg")
    self.Mixed_7c = InceptionE(2048, "max")
    self.fc = nn.Linear(POOL_DIM, LOGITS_DIM)

  def stem(self, x):
    """The input scaled by 2x - 1, then the layers up to Mixed_5b."""
    x = 2 * x - 1
    x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
    x = F.max_pool2d(x, 3, stride=2)
    x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
    return F.max_pool2d(x, 3, stride=2)

  def forward(self, x):
    x = self.stem(x)
    for name in MIXED:
      x = getattr(self, name)(x)
    pool = x.mean(dim=(2, 3))
    return pool, self.fc(pool)


MIXED = ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b",
         "Mixed_6c", "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b",
         "Mixed_7c")


def random_inception(seed: int = 0) -> InceptionV3FID:
  """The network in eval mode with deterministic random weights: convs
  N(0, 2 / fan_in) (activations keep their scale through the ReLUs), the
  head N(0, 1 / fan_in), BatchNorm at its identity statistics; drawn on
  the CPU from `seed`."""
  logging.warning(
      "InceptionV3: no weight file found; using DETERMINISTIC RANDOM "
      "weights. FID/IS/KID values are internally consistent but NOT "
      "comparable to reference numbers. Set $INDM_INCEPTION_WEIGHTS to a "
      "pytorch-fid state_dict or clean-fid's torchscript archive to enable "
      "real metrics.")
  gen = torch.Generator().manual_seed(seed)
  model = InceptionV3FID()
  with torch.no_grad():
    for m in model.modules():
      if isinstance(m, (nn.Conv2d, nn.Linear)):
        fan_in = m.weight[0].numel()
        gain = 2.0 if isinstance(m, nn.Conv2d) else 1.0
        m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                       * (gain / fan_in) ** 0.5)
        if m.bias is not None:
          m.bias.zero_()
  model.weights_source = "random"
  return model.eval()


_LAST_SOURCE: Optional[str] = None


def weights_source() -> str:
  """The provenance of the weights `load_inception` resolved last: the
  file's absolute path, or "random"; before any load, what the
  environment would give. A network from `load_inception` or
  `random_inception` also carries its own as `model.weights_source`."""
  if _LAST_SOURCE is not None:
    return _LAST_SOURCE
  path = os.environ.get("INDM_INCEPTION_WEIGHTS", "")
  return os.path.abspath(path) if path and os.path.exists(path) else "random"


def read_state_dict(path: str) -> dict:
  """A pytorch-fid state_dict from `path`: a torch-saved state_dict (or
  module), or clean-fid's torchscript archive translated by
  `torchscript_to_fid_state_dict` (`scripts/convert_inception.py`'s
  `--src`)."""
  try:
    ts = torch.jit.load(path, map_location="cpu")
  except RuntimeError:
    ts = None
  if ts is not None:
    named = dict(ts.named_parameters())
    named.update(dict(ts.named_buffers()))
    return torchscript_to_fid_state_dict(named)
  try:
    obj = torch.load(path, map_location="cpu", weights_only=False)
  except Exception as e:
    raise ValueError(f"{path} is neither a torch state_dict nor a "
                     "torchscript archive (the JAX package's flax weight "
                     "file is not read by the port)") from e
  state_dict = obj.state_dict() if hasattr(obj, "state_dict") else obj
  if any(k.split(".")[0].startswith(("mixed", "conv", "layers", "output"))
         for k in state_dict):
    state_dict = torchscript_to_fid_state_dict(state_dict)
  return state_dict


def load_inception(path: Optional[str] = None,
                   device="cuda") -> InceptionV3FID:
  """The network in eval mode on `device`, its weights from `path` (default
  $INDM_INCEPTION_WEIGHTS) or, with no file there, `random_inception()`;
  `weights_source()` then names the file or "random"."""
  global _LAST_SOURCE
  path = path or os.environ.get("INDM_INCEPTION_WEIGHTS", "")
  if not path or not os.path.exists(path):
    _LAST_SOURCE = "random"
    return random_inception().to(device)
  model = InceptionV3FID()
  missing, unexpected = model.load_state_dict(read_state_dict(path),
                                              strict=False)
  missing = [k for k in missing if not k.endswith("num_batches_tracked")]
  if missing or unexpected:
    raise KeyError(f"{path}: missing {missing[:5]}, unexpected "
                   f"{unexpected[:5]}")
  logging.info("InceptionV3 weights loaded from %s", path)
  _LAST_SOURCE = model.weights_source = os.path.abspath(path)
  return model.eval().to(device)


def resize_bilinear(x, size: int = SIZE):
  """[B, C, H, W] -> [B, C, size, size], `jax.image.resize(..., "bilinear")`
  (triangle kernel on half-pixel centres, antialiased when it shrinks);
  the identity at `size`."""
  if x.shape[-2:] == (size, size):
    return x
  return F.interpolate(x, size=(size, size), mode="bilinear",
                       align_corners=False, antialias=True)


def feature_extractor(model: Optional[InceptionV3FID] = None,
                      batch_size: int = 64, device="cuda"):
  """extract(images [N, H, W, C] in [0, 1], numpy or tensor) -> (pool
  [N, 2048], logits [N, 1008]) as float32 numpy arrays: batches of
  `batch_size` on `device`, each resized to 299 (`resize_bilinear`) and
  run through `model` (default `load_inception()`) under no_grad."""
  if model is None:
    model = load_inception(device=device)

  @torch.no_grad()
  def extract(images):
    if not torch.is_tensor(images):
      images = torch.from_numpy(np.asarray(images, np.float32))
    pools, logits = [], []
    for i in range(0, len(images), batch_size):
      chunk = images[i:i + batch_size].to(device=device, dtype=torch.float32)
      p, l = model(resize_bilinear(chunk.permute(0, 3, 1, 2)))
      pools.append(p.cpu().numpy())
      logits.append(l.cpu().numpy())
    return np.concatenate(pools), np.concatenate(logits)

  return extract


# clean-fid's torchscript archive names its units as the tfhub graph of the
# FID inception ("pool_3" network) does (`cleanfid/features.py:13-48`),
# keyed here by the pytorch-fid module names of this network
_TF_STEM = {
    "Conv2d_1a_3x3": "conv", "Conv2d_2a_3x3": "conv_1",
    "Conv2d_2b_3x3": "conv_2", "Conv2d_3b_1x1": "conv_3",
    "Conv2d_4a_3x3": "conv_4", "fc": "output",
}
_TF_MIXED = {
    "Mixed_5b": "mixed", "Mixed_5c": "mixed_1", "Mixed_5d": "mixed_2",
    "Mixed_6a": "mixed_3", "Mixed_6b": "mixed_4", "Mixed_6c": "mixed_5",
    "Mixed_6d": "mixed_6", "Mixed_6e": "mixed_7", "Mixed_7a": "mixed_8",
    "Mixed_7b": "mixed_9", "Mixed_7c": "mixed_10",
}
_TF_BRANCH = {
    # A blocks (5b/5c/5d)
    "branch1x1": "conv",
    "branch5x5_1": "tower.conv", "branch5x5_2": "tower.conv_1",
    "branch3x3dbl_1": "tower_1.conv", "branch3x3dbl_2": "tower_1.conv_1",
    "branch3x3dbl_3": "tower_1.conv_2",
    "branch_pool": "tower_2.conv",
    # B block (6a) reuses branch3x3dbl_* under 'tower'
    "branch3x3": "conv",
    # C blocks (6b-6e)
    "branch7x7_1": "tower.conv", "branch7x7_2": "tower.conv_1",
    "branch7x7_3": "tower.conv_2",
    "branch7x7dbl_1": "tower_1.conv", "branch7x7dbl_2": "tower_1.conv_1",
    "branch7x7dbl_3": "tower_1.conv_2", "branch7x7dbl_4": "tower_1.conv_3",
    "branch7x7dbl_5": "tower_1.conv_4",
    # D block (7a)
    "branch3x3_1": "tower.conv", "branch3x3_2": "tower.conv_1",
    "branch7x7x3_1": "tower_1.conv", "branch7x7x3_2": "tower_1.conv_1",
    "branch7x7x3_3": "tower_1.conv_2", "branch7x7x3_4": "tower_1.conv_3",
    # E blocks (7b/7c)
    "branch3x3_2a": "tower.mixed.conv", "branch3x3_2b": "tower.mixed.conv_1",
    "branch3x3dbl_3a": "tower_1.mixed.conv",
    "branch3x3dbl_3b": "tower_1.mixed.conv_1",
}
# 6a's branch3x3dbl_* live under 'tower' (not tower_1)
_TF_6A = {"branch3x3": "conv", "branch3x3dbl_1": "tower.conv",
          "branch3x3dbl_2": "tower.conv_1", "branch3x3dbl_3": "tower.conv_2"}


def _tf_unit_name(fid_module: str) -> str:
  """pytorch-fid module path -> tfhub unit name (e.g.
  'Mixed_6b.branch7x7dbl_3' -> 'mixed_5.tower_1.conv_2')."""
  parts = fid_module.split(".")
  if parts[0] in _TF_STEM:
    return _TF_STEM[parts[0]]
  table = dict(_TF_BRANCH)
  if parts[0] == "Mixed_6a":
    table.update(_TF_6A)
  return f"{_TF_MIXED[parts[0]]}.{table[parts[1]]}"


def fid_conv_modules() -> Sequence[str]:
  """Every BasicConv2d of the network by its pytorch-fid path."""
  with torch.device("meta"):
    model = InceptionV3FID()
  return [name for name, m in model.named_modules()
          if isinstance(m, BasicConv2d)]


def torchscript_to_fid_state_dict(named_tensors) -> dict:
  """clean-fid's torchscript layout (tfhub graph names: conv/conv_1..
  conv_4, mixed..mixed_10 with tower/tower_1/tower_2 branches, 'output'
  logits head) -> the pytorch-fid state_dict of this network.

  `named_tensors`: flat {name: tensor} from the archive's
  named_parameters() and named_buffers(); '/'- or '.'-separated names,
  an optional leading 'layers.'/'base.'/'module.'/'model.', and several
  conv/bn leaf spellings. TF inception fixes the BatchNorm scale at 1, so a
  missing gamma becomes ones. Every unit it cannot resolve is listed in
  the KeyError it raises."""
  norm = {}
  for k, v in named_tensors.items():
    k = k.replace("/", ".")
    for prefix in ("layers.", "base.", "module.", "model."):
      if k.startswith(prefix):
        k = k[len(prefix):]
    norm[k] = v

  def find(unit, suffixes):
    for s in suffixes:
      if f"{unit}{s}" in norm:
        return norm[f"{unit}{s}"]
    return None

  out, missing = {}, []
  for m in fid_conv_modules():
    unit = _tf_unit_name(m)
    w = find(unit, [".conv.weight", ".weight", ".w"])
    beta = find(unit, [".bn.bias", ".bn.beta", ".beta", ".bias"])
    mean = find(unit, [".bn.running_mean", ".bn.mean", ".mean",
                       ".running_mean"])
    var = find(unit, [".bn.running_var", ".bn.var", ".var", ".running_var"])
    gamma = find(unit, [".bn.weight", ".bn.gamma", ".gamma"])
    if w is None or beta is None or mean is None or var is None:
      missing.append((m, unit))
      continue
    out[f"{m}.conv.weight"] = w
    out[f"{m}.bn.weight"] = (gamma if gamma is not None
                             else torch.ones_like(beta))
    out[f"{m}.bn.bias"] = beta
    out[f"{m}.bn.running_mean"] = mean
    out[f"{m}.bn.running_var"] = var
  fc_w = find("output", [".weight", ".fc.weight", ".w"])
  fc_b = find("output", [".bias", ".fc.bias", ".b"])
  if fc_w is None or fc_b is None:
    missing.append(("fc", "output"))
  else:
    out["fc.weight"] = fc_w
    out["fc.bias"] = fc_b
  if missing:
    raise KeyError(
        f"torchscript layout: {len(missing)} units unresolved "
        f"(first: {missing[:5]}); available keys start with "
        f"{sorted(norm)[:20]}. Adapt the suffix tables in "
        "torchscript_to_fid_state_dict.")
  return out

