"""The port's own config tree and its import boundary.

The port may not import JAX, flax, ml_collections, absl or the JAX
package: the machine with the card has none of them.
"""

import ast
import filecmp
import os

import pytest

from indm_torch import configs as torch_configs
from indm_torch.configs import wolf_presets as torch_presets
from indm_tpu import configs as jax_configs
from indm_tpu.configs import wolf_presets as jax_presets
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "ml_collections", "absl",
             "indm_tpu", "msgpack", "torchvision"}
NAME = "vp/CIFAR10/indm_nll"


def _assert_leaves_equal(name):
  """Every leaf the port defines has the JAX config's name and value; the
  port leaves out only the JAX-specific `config.jax` section."""
  ours = dict(torch_configs.get_config(name).leaves())
  theirs = jax_configs.get_config(name).to_dict()

  def flat(d, prefix=""):
    for k, v in d.items():
      if isinstance(v, dict):
        yield from flat(v, f"{prefix}{k}.")
      else:
        yield f"{prefix}{k}", v

  theirs = {k: v for k, v in flat(theirs) if not k.startswith("jax.")}
  assert ours == theirs


def test_config_leaves_equal_jax_config():
  _assert_leaves_equal(NAME)


def test_ve_config_leaves_equal_jax_config():
  _assert_leaves_equal("ve/CIFAR10/indm")
  assert torch_configs.list_configs() == [
      "ve/CELEBA/indm", "ve/CIFAR10/indm", "vp/CELEBA/indm_fid",
      "vp/CELEBA/indm_nll", "vp/CIFAR10/indm_fid", NAME]


@pytest.mark.parametrize("name", ["vp/CELEBA/indm_nll", "vp/CELEBA/indm_fid",
                                  "ve/CELEBA/indm"])
def test_celeba_config_leaves_equal_jax_config(name):
  _assert_leaves_equal(name)


def test_config_overrides_keep_types():
  cfg = torch_configs.get_config(NAME)
  cfg.set_dotted("model.fused_groupnorm", "true")
  cfg.set_dotted("model.init_scale", "1")
  cfg.set_dotted("model.ch_mult", "(1, 2)")
  assert cfg.model.fused_groupnorm is True
  assert cfg.model.init_scale == 1.0 and isinstance(cfg.model.init_scale,
                                                     float)
  assert cfg.model.ch_mult == (1, 2)
  with pytest.raises(ValueError):
    cfg.set_dotted("model.nf", "wide")
  with pytest.raises(KeyError):
    cfg.set_dotted("model.no_such_leaf", "1")


def _assert_vendored(name, rel):
  key = torch_configs.get_config(name).flow.model_config
  assert key.endswith(rel)
  assert torch_presets.load_wolf_params(key) == jax_presets.load_wolf_params(
      key)
  rel = "wolf_configs/" + rel
  assert filecmp.cmp(os.path.join(REPO, "indm_torch", "configs", rel),
                     os.path.join(REPO, "indm_tpu", "configs", rel),
                     shallow=False)


def test_wolf_preset_is_the_vendored_json():
  _assert_vendored(NAME, "cifar10/glow/resflow-gaussian-uni.json")


@pytest.mark.parametrize("name", ["vp/CELEBA/indm_nll", "vp/CELEBA/indm_fid",
                                  "ve/CELEBA/indm"])
def test_imagenet64_wolf_preset_is_the_vendored_json(name):
  """CelebA's preset: the imagenet-64 JSON, a copy of the JAX package's,
  its encoder on the squeezed image's 12 planes."""
  _assert_vendored(name, "imagenet/64x64/glow/resflow-gaussian-uni.json")
  params = torch_presets.load_wolf_params(
      torch_configs.get_config(name).flow.model_config)
  assert params["discriminator"]["encoder"]["in_planes"] == 12


def _jax_presets():
  root = os.path.join(REPO, "indm_tpu", "configs", "wolf_configs")
  return sorted(os.path.relpath(os.path.join(r, f), root)
                for r, _, fs in os.walk(root) for f in fs
                if f.endswith(".json"))


def test_all_22_wolf_presets_are_vendored():
  ours = os.path.join(REPO, "indm_torch", "configs", "wolf_configs")
  assert len(_jax_presets()) == 22
  assert sorted(os.path.relpath(os.path.join(r, f), ours)
                for r, _, fs in os.walk(ours) for f in fs) == _jax_presets()


@pytest.mark.parametrize("rel", _jax_presets())
def test_vendored_wolf_preset_equals_jax(rel):
  """Each of the 22 presets byte for byte, and resolved by the same
  `flow.model_config` string to the same dict."""
  assert filecmp.cmp(
      os.path.join(REPO, "indm_torch", "configs", "wolf_configs", rel),
      os.path.join(REPO, "indm_tpu", "configs", "wolf_configs", rel),
      shallow=False)
  key = "flow_models/wolf/wolf_configs/" + rel
  assert torch_presets.load_wolf_params(key) == jax_presets.load_wolf_params(
      key)


def _port_files():
  for root, _, files in os.walk(os.path.join(REPO, "indm_torch")):
    for f in files:
      if f.endswith(".py"):
        yield os.path.join(root, f)
  yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_nothing_of_jax():
  files = list(_port_files())
  assert len(files) > 10
  bad = []
  for path in files:
    with open(path) as f:
      tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
      if isinstance(node, ast.Import):
        names = [a.name for a in node.names]
      elif isinstance(node, ast.ImportFrom):
        names = [node.module or ""]
      else:
        continue
      bad += [(path, n) for n in names if n.split(".")[0] in FORBIDDEN]
  assert not bad, bad


def test_every_port_module_imports_without_a_card():
  """Importing a module builds no kernel and needs no card, nvcc or
  triton: every module of the port imports here."""
  import importlib
  pkg = os.path.join(REPO, "indm_torch")
  names = sorted(
      os.path.relpath(p, REPO)[:-3].replace(os.sep, ".")
      for p in _port_files() if p.startswith(pkg + os.sep)
      and not p.endswith("__init__.py"))
  assert "indm_torch.ops.neumann" in names and "indm_torch.joint" in names
  assert "indm_torch.ops.upfirdn2d" in names
  assert "indm_torch.metrics.inception" in names
  assert "indm_torch.metrics.fid" in names
  for name in names:
    importlib.import_module(name)


def test_train_cli_raises_without_a_card():
  """`python -m indm_torch.train` runs on the card unless `--device cpu`
  is given; with no card it raises instead of carrying on on the CPU."""
  import torch
  from indm_torch import train
  if torch.cuda.is_available():
    pytest.skip("a card is present")
  with pytest.raises(RuntimeError, match="no CUDA card"):
    train.main(["--steps", "1"])


def test_import_scan_covers_the_score_nets():
  """The scan above reads every score net's module (NCSN++, DDPM, the
  RefineNets and their norms, VDM) and the fused activation."""
  files = {os.path.relpath(p, REPO) for p in _port_files()}
  for rel in ("models/ncsnpp.py", "models/ddpm.py", "models/ncsnv2.py",
              "models/normalization.py", "models/vdm.py",
              "models/registry.py", "ops/fused_act.py"):
    assert os.path.join("indm_torch", rel) in files
