"""All 22 wolf presets in the port, without JAX.

Every vendored preset constructs and runs one training forward (the
encoding direction, with its log-det and KL) at widths shrunk as
`tests/test_wolf_flows.py:_shrink_widths` shrinks them, on the
preset's own types; and a checkpoint round trip of the Glow and MaCow
parameters and the discriminators' entries. `test_torch_wolf_kinds.py`
holds one preset of each kind against the JAX package.
"""

import os

import numpy as np
import pytest
import torch

from indm_torch import checkpoint as torch_ckpt
from indm_torch import configs as torch_configs
from indm_torch.configs import wolf_presets as torch_presets
from indm_torch.flows import flow_model as torch_fm
from test_wolf_flows import _shrink_widths
from torch_threads import one_torch_thread  # noqa: F401

NAME = "vp/CIFAR10/indm_nll"
PREFIX = "flow_models/wolf/wolf_configs/"
ROOT = os.path.join(os.path.dirname(torch_presets.__file__), "wolf_configs")
PRESETS = sorted(os.path.relpath(os.path.join(r, f), ROOT)
                 for r, _, fs in os.walk(ROOT) for f in fs)
B = 2


def preset_config(preset, cfg_module=torch_configs):
  """The config of the JAX package's 22-preset test: image size the
  preset's floor, the resflow generator tiny; flow.squeeze where the
  resflow preset's encoder reads 12 planes."""
  raw = torch_presets.load_wolf_params(PREFIX + preset)
  c = cfg_module.get_config(NAME)
  c.flow.model_config = PREFIX + preset
  c.flow.nblocks = "2"
  c.flow.intermediate_dim = 16
  levels = int(raw["generator"]["flow"].get("levels", 3))
  enc = raw["discriminator"].get("encoder") or {}
  c.data.image_size = max(2 ** levels, 2 ** (int(enc.get("levels", 0)) + 1),
                          16)
  c.flow.squeeze = enc.get("in_planes") == 12
  return c, raw


def test_all_22_presets_are_vendored():
  assert len(PRESETS) == 22


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_constructs_and_runs_a_forward(preset, monkeypatch):
  c, raw = preset_config(preset)
  real = torch_presets.load_wolf_params
  monkeypatch.setattr(torch_fm, "load_wolf_params",
                      lambda mc: _shrink_widths(real(mc)))
  flow = torch_fm.FlowModel(c, generator=torch.Generator().manual_seed(0))
  flow.train()
  size = c.data.image_size
  x = torch.rand(B, 3, size, size,
                 generator=torch.Generator().manual_seed(1)) * 0.5
  y = (torch.zeros(B, dtype=torch.long)
       if raw["discriminator"]["type"] == "categorical" else None)
  z, ld = torch_fm.flow_forward(c, flow, x, train=True, y=y,
                                generator=torch.Generator().manual_seed(2),
                                host_rng=np.random.default_rng(3))
  assert z.shape == x.shape and torch.isfinite(z).all(), preset
  assert ld.shape == (B,) and torch.isfinite(ld).all(), preset
  kind = raw["generator"]["flow"]["type"]
  assert flow.gen_kind == kind
  assert (flow.gen_module is None) == (kind == "resflow")


def test_glow_and_macow_checkpoint_round_trip(tmp_path, monkeypatch):
  """The generators' parameters and the encoder's and categorical
  discriminator's entries saved and restored (`indm_torch.checkpoint`):
  the same state and the same z."""
  real = torch_presets.load_wolf_params
  monkeypatch.setattr(torch_fm, "load_wolf_params",
                      lambda mc: _shrink_widths(real(mc)))
  for preset in ("cifar10/glow/glow-gaussian-uni.json",
                 "cifar10/macow/macow-cat-uni.json"):
    c, raw = preset_config(preset)
    flow = torch_fm.FlowModel(c, generator=torch.Generator().manual_seed(0))
    x = torch.rand(B, 3, c.data.image_size, c.data.image_size)
    y = torch.tensor([1, 2]) if "cat" in preset else None
    torch_fm.flow_forward(c, flow.train(), x, train=True, y=y)  # buffers
    path = str(tmp_path / preset.replace("/", "_") / "flow_checkpoint.pth")
    torch_ckpt.save_checkpoint(path, {"model": flow.state_dict(), "step": 3})
    fresh = torch_fm.FlowModel(c, generator=torch.Generator().manual_seed(5))
    state = torch_ckpt.restore_checkpoint(c, path, fresh)
    assert state["step"] == 3
    for k, v in flow.state_dict().items():
      assert torch.equal(fresh.state_dict()[k], v), k
    outs = [torch_fm.flow_forward(c, m.eval(), x, y=y)[0]
            for m in (flow, fresh)]
    assert torch.equal(outs[0], outs[1])
