"""One Glow preset with each discriminator kind and the normal prior
against the JAX package (`wolf_kinds.py` has the checks and their
tolerances)."""

import wolf_kinds
from torch_threads import one_torch_thread  # noqa: F401

kind = wolf_kinds.kind_fixture(["glow_base", "glow_categorical",
                                "glow_gaussian",
                                "glow_gaussian_normal_prior"])


def test_glow_preset_forward_matches_jax(kind):
  wolf_kinds.check_forward(kind)


def test_glow_preset_reverse_matches_jax(kind):
  wolf_kinds.check_reverse(kind)
