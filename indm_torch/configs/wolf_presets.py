"""Wolf flow presets: the second, JSON layer of the config.

`config.flow.model_config` names a JSON file by the reference's path string;
the port vendors the one preset its slice runs
(`wolf_configs/cifar10/glow/resflow-gaussian-uni.json`).
"""

import json
import os

_PREFIX = "flow_models/wolf/wolf_configs/"


def load_wolf_params(model_config: str) -> dict:
  """Resolve a wolf model config: a vendored JSON under
  `indm_torch/configs/wolf_configs/` addressed by the reference's path
  string, or a JSON file path."""
  rel = model_config
  if rel.startswith(_PREFIX):
    rel = rel[len(_PREFIX):]
  vendored = os.path.join(os.path.dirname(__file__), "wolf_configs", rel)
  for path in (vendored, model_config):
    if os.path.exists(path):
      with open(path) as f:
        return json.load(f)
  raise KeyError(f"Unknown wolf model config: {model_config!r}")
