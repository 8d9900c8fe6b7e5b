"""The port's VDM (`indm_torch/models/vdm.py`) against the JAX package's
(`indm_tpu/models/vdm.py`): the net on gamma labels (positional) and on
noise levels (Fourier), its asserts, the score function with and without
gamma(t) (no caller of either package passes it: both fail without), the
noise schedule and `get_gamma_fn`, and the auxiliary state of
`run_lib.load_vdm_aux` carried from the JAX package's, saved with the meta
checkpoint and restored bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import score_nets as sn
from indm_torch import convert
from indm_torch import run_lib as torch_run_lib
from indm_torch import sde as torch_sde
from indm_torch.models import registry as torch_registry
from indm_torch.models import vdm as torch_vdm
from indm_tpu import run_lib as jax_run_lib
from indm_tpu import sde as jax_sde
from indm_tpu.models import create_model as jax_create_model
from indm_tpu.models import get_score_fn as jax_get_score_fn
from indm_tpu.models import vdm as jax_vdm
from score_nets import unoptimized_xla  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

VDM = {"model.name": "vdm"}
GAMMA = np.array([-6.5, 4.0], np.float32)


def test_vdm_matches_jax_on_gamma_labels():
  _, _, module, variables, model = sn.nets(**VDM)
  assert isinstance(model, torch_vdm.VDM)
  sn.compare_nets(module, variables, model, sn.images(2, 8), GAMMA)


def test_vdm_fourier_matches_jax():
  """Under VESDE with `scale_by_sigma` off: noise levels as labels."""
  _, _, module, variables, model = sn.nets(
      "ve/CIFAR10/indm", **VDM, **{"model.scale_by_sigma": False})
  sn.compare_nets(module, variables, model, sn.images(2, 8),
                  np.array([0.05, 20.0], np.float32))


@pytest.mark.parametrize("leaves", [{"model.resblock_type": "ddpm"},
                                    {"model.auxiliary_resblock": False},
                                    {"model.scale_by_sigma": True}])
def test_vdm_asserts_as_jax(leaves):
  jc, tc = sn.configs(**VDM, **leaves)
  with pytest.raises(AssertionError):
    jax_create_model(jc, jax.random.PRNGKey(0))
  with pytest.raises(ValueError):
    torch_registry.create_model(tc, device="cpu")


def test_score_fn_takes_gamma_t_or_fails_as_jax():
  """VP's continuous labels of the VDM net are `gamma_t`: given, both
  score functions agree; not given (as every caller leaves it), the JAX
  net fails on None and the port raises."""
  jc, tc, module, variables, model = sn.nets(**VDM)
  x, t = sn.images(2, 8, seed=2), np.array([0.7, 0.1], np.float32)
  j_sde, t_sde = jax_sde.get_sde(jc), torch_sde.get_sde(tc)
  want = np.asarray(jax_get_score_fn(
      jc, j_sde, module, variables, gamma_t=jnp.asarray(GAMMA),
      continuous=True)(jnp.asarray(x), jnp.asarray(t)))
  got = torch_registry.get_score_fn(
      tc, t_sde, model, gamma_t=torch.from_numpy(GAMMA))(
          sn.nchw(x), torch.from_numpy(t))
  sn.assert_close(sn.nhwc(got), want)
  with pytest.raises(AttributeError):
    jax_get_score_fn(jc, j_sde, module, variables, continuous=True)(
        jnp.asarray(x), jnp.asarray(t))
  with pytest.raises(ValueError, match="gamma"):
    torch_registry.get_score_fn(tc, t_sde, model)(sn.nchw(x),
                                                  torch.from_numpy(t))


def _jax_aux(tmp_path):
  jc, tc = sn.configs(**VDM)
  aux = jax_run_lib.load_vdm_aux(jc, str(tmp_path), jax.random.PRNGKey(7))
  return jc, tc, aux


def test_noise_schedule_and_gamma_fn_match_jax(tmp_path):
  jc, _, aux = _jax_aux(tmp_path)
  params = sn.np_tree(aux["state"].params)
  port = torch_vdm.VDMAux()
  port.load_state_dict(convert.vdm_aux_state_dict_from_jax(params),
                       strict=True)
  t = np.linspace(0.0, 1.0, 7).astype(np.float32)
  want = np.asarray(aux["module"].apply({"params": params["schedule"]},
                                        jnp.asarray(t)))
  with torch.no_grad():
    got = port.schedule(torch.from_numpy(t)).numpy()
  np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
  g_j = jax_vdm.get_gamma_fn(jc, params["gamma"], {"params": params[
      "schedule"]}, aux["module"])(jnp.asarray(t))
  with torch.no_grad():
    g_t = torch_vdm.get_gamma_fn(port.gamma, port.schedule)(
        torch.from_numpy(t))
  np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-5,
                             atol=1e-5)


def test_aux_state_saved_and_restored_bit_for_bit(tmp_path):
  """A VE score-only step of the VDM net (its labels the noise levels)
  through `run_lib.train_steps` writes the auxiliary state beside the meta
  checkpoint, as the JAX loop does; `load_vdm_aux` reads it back bit for
  bit, and no other net has one."""
  _, tc = sn.configs("ve/CIFAR10/indm", **VDM, **{
      "model.scale_by_sigma": False, "flow.model": "identity",
      "training.batch_size": 2})
  tr = torch_run_lib.build_training(tc, device="cpu",
                                    workdir=str(tmp_path))
  assert tr.vdm_aux is not None and tr.vdm_aux["step"] == 0
  torch_run_lib.train_steps(tr, 1, log=lambda *a: None)
  path = tmp_path / "checkpoints-meta" / "vdm_aux_checkpoint.pth"
  assert path.exists()
  again = torch_run_lib.load_vdm_aux(tc, str(tmp_path), seed=99,
                                    device="cpu")
  saved = tr.vdm_aux["model"].state_dict()
  got = again["model"].state_dict()
  assert set(got) == set(saved) == {
      "gamma", *(f"schedule.Dense_{i}.{k}" for i in range(3)
                 for k in ("weight", "bias"))}
  for k, v in saved.items():
    assert torch.equal(got[k], v), k
  for a, b in zip(again["ema"].shadow, tr.vdm_aux["ema"].shadow):
    assert torch.equal(a, b)
  _, tc_plain = sn.configs()
  assert torch_run_lib.load_vdm_aux(tc_plain, str(tmp_path), 0,
                                    device="cpu") is None
