"""Experiment configs without `ml_collections`.

`ConfigDict` is a small attribute dict with the access pattern the port
reads (`config.model.nf`, `config.flow.get("x", default)`).
`get_config("vp/CIFAR10/indm_nll")` (or `"vp/CIFAR10/indm_fid"`,
`"ve/CIFAR10/indm"`) builds the
same leaves, under the same names and values, as the JAX package's config
of that name.
"""

from __future__ import annotations

import ast
import copy


class ConfigDict(dict):
  """Nested attribute dict: `cfg.a.b` reads and writes `cfg["a"]["b"]`."""

  def __getattr__(self, name):
    try:
      return self[name]
    except KeyError:
      raise AttributeError(name) from None

  def __setattr__(self, name, value):
    self[name] = value

  def __deepcopy__(self, memo):
    return ConfigDict({k: copy.deepcopy(v, memo) for k, v in self.items()})

  def leaves(self, prefix: str = ""):
    """Yield (dotted name, value) for every non-dict leaf."""
    for k, v in self.items():
      name = f"{prefix}{k}"
      if isinstance(v, ConfigDict):
        yield from v.leaves(name + ".")
      else:
        yield name, v

  def set_dotted(self, name: str, text: str):
    """Override one existing leaf from command-line text (`model.nf=64`).

    The text is parsed as a Python literal (`true`/`false` are accepted)
    and must match the type of the value it replaces."""
    *path, leaf = name.split(".")
    node = self
    for p in path:
      node = node[p]
    if leaf not in node:
      raise KeyError(f"unknown config leaf {name!r}")
    old = node[leaf]
    lowered = text.strip().lower()
    if lowered in ("true", "false"):
      value = lowered == "true"
    else:
      try:
        value = ast.literal_eval(text)
      except (ValueError, SyntaxError):
        value = text
    if isinstance(old, bool) != isinstance(value, bool):
      raise ValueError(f"{name}: expected {type(old).__name__}, got {text!r}")
    if isinstance(old, float) and isinstance(value, int):
      value = float(value)
    if old is not None and not isinstance(value, type(old)):
      raise ValueError(f"{name}: expected {type(old).__name__}, got {text!r}")
    node[leaf] = value


from indm_torch.configs.defaults import ve_indm, vp_indm  # noqa: E402

_REGISTRY = {
    "vp/CIFAR10/indm_nll": lambda: vp_indm("CIFAR10", nll=True),
    "vp/CIFAR10/indm_fid": lambda: vp_indm("CIFAR10", nll=False),
    "ve/CIFAR10/indm": lambda: ve_indm("CIFAR10"),
}


def list_configs():
  return sorted(_REGISTRY)


def get_config(name: str) -> ConfigDict:
  name = name.replace(".py", "").strip("/")
  if name.startswith("configs/"):
    name = name[len("configs/"):]
  if name not in _REGISTRY:
    raise KeyError(f"Unknown config {name!r}; available: {list_configs()}")
  return _REGISTRY[name]()
