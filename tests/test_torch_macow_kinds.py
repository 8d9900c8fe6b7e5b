"""One MaCow preset with each discriminator kind against the JAX package
(`wolf_kinds.py` has the checks and their tolerances).

MaCow's gradients are held on a small MaCow by `test_torch_wolf_macow.py`:
the JAX package's backward through the shrunk presets' 96 autoregressive
loops takes minutes to compile; here the encoding direction's values.
"""

import wolf_kinds
from torch_threads import one_torch_thread  # noqa: F401

kind = wolf_kinds.kind_fixture(["macow_base", "macow_categorical",
                                "macow_gaussian"])


def test_macow_preset_forward_matches_jax(kind):
  wolf_kinds.check_forward(kind)


def test_macow_preset_reverse_matches_jax(kind):
  wolf_kinds.check_reverse(kind)
