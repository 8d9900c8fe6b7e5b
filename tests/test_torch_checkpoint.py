"""The port's checkpoints (`indm_torch.checkpoint`, `run_lib.load_model`,
`load_flow_model`, `build_training(workdir=...)`, `train_steps`) and the
training CLI's resume.

A tiny port checkpoint reloads bit for bit; N + M steps in two calls equal
N + M steps in one; the JAX package's rules hold (no optimizer under VESDE
unless kept, `optim.reset`, `flow.optim_reset`, the score EMA reset when
no flow checkpoint exists, `eval.target_ckpt`); and the files, in the
reference's `{optimizer, model, ema, step}` layout, read through the JAX
package's existing converters (`indm_tpu/models/convert.py`,
`indm_tpu/flows/convert.py`) into JAX models whose outputs equal the
port's. That last test also pins the EMA shadow order against
`named_parameters()`, which the JAX package's own test checks only with
the reference checkout.

Geometry: the tiny training configuration of
`tests/test_torch_train_step.py` (its tiny wolf preset), with dropout on so
that the torch generator's state matters.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train_step as tts
from indm_torch import checkpoint as ckpt_lib
from indm_torch import configs as torch_configs
from indm_torch import run_lib
from indm_torch import train as train_cli
from indm_torch.configs import wolf_presets as torch_presets
from indm_torch.flows import flow_model as torch_fm
from indm_tpu import configs as jax_configs
from indm_tpu.configs import wolf_presets as jax_presets
from indm_tpu.flows import convert as jax_flow_convert
from indm_tpu.flows import flow_model as jax_fm
from indm_tpu.models import create_model as jax_create_model
from indm_tpu.models.convert import (ema_state_dict_from_torch,
                                     ncsnpp_params_from_torch)
from torch_threads import one_torch_thread  # noqa: F401

TINY = {**tts.TINY, "model.dropout": 0.1}
# float32 convs and sums in another order through both nets
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def tiny_preset():
  jax_presets.PRESETS["tiny-train"] = tts.TINY_WOLF
  torch_presets.PRESETS["tiny-train"] = tts.TINY_WOLF
  yield
  jax_presets.PRESETS.pop("tiny-train", None)
  torch_presets.PRESETS.pop("tiny-train", None)


def tiny_config(**extra):
  tc = torch_configs.get_config("vp/CIFAR10/indm_nll")
  for k, v in {**TINY, **extra}.items():
    tts._set(tc, k, v)
  tc.optim.reset = False
  return tc


def build(workdir, config=None):
  return run_lib.build_training(config or tiny_config(), device="cpu",
                                workdir=str(workdir))


def quiet(*a):
  pass


def state_of(tr):
  """Every tensor and generator state a resume must restore."""
  return {
      "score": tr.score_model.state_dict(), "flow": tr.flow_model.state_dict(),
      "opts": [(o.count, o.mu, o.nu) for o in (tr.score_opt, tr.flow_opt)],
      "emas": [(e.num_updates, e.shadow) for e in (tr.score_ema,
                                                  tr.flow_ema)],
      "rngs": (tr.np_rng.bit_generator.state, tr.host_rng.bit_generator.state,
               tr.generator.get_state(), tr.batches.rng.bit_generator.state,
               tr.batches._order.tolist()),
      "step": tr.step}


def assert_same(a, b, path="state"):
  """Equal bit for bit: tensors by `torch.equal`, containers item by item."""
  if isinstance(a, torch.Tensor):
    assert torch.equal(a, b), path
  elif isinstance(a, dict):
    assert a.keys() == b.keys(), path
    for k in a:
      assert_same(a[k], b[k], f"{path}.{k}")
  elif isinstance(a, (list, tuple)):
    assert len(a) == len(b), path
    for i, (x, y) in enumerate(zip(a, b)):
      assert_same(x, y, f"{path}[{i}]")
  else:
    assert a == b, path


def test_restore_is_bit_for_bit(tmp_path):
  """After two steps and a save, a fresh `Training` built from the work
  directory holds every parameter, moment, count, EMA shadow, BatchNorm
  buffer, generator state and the batches' place of the saved one."""
  tr = build(tmp_path)
  run_lib.train_steps(tr, 2, log=quiet)
  again = build(tmp_path)
  assert again.step == 2 and again.restore_seconds > 0
  assert_same(state_of(tr), state_of(again))
  bn = [k for k in again.flow_model.state_dict() if "running_" in k]
  assert bn and not all(
      torch.equal(again.flow_model.state_dict()[k],
                  torch.zeros_like(again.flow_model.state_dict()[k]))
      for k in bn if k.endswith("running_mean"))


def test_two_calls_equal_one(tmp_path):
  """Two steps, then one more from the checkpoint: the third step's losses
  and the whole state equal three steps in one call, bit for bit."""
  first = build(tmp_path / "a")
  run_lib.train_steps(first, 2, log=quiet)
  resumed = build(tmp_path / "a")
  (row,) = run_lib.train_steps(resumed, 1, log=quiet)
  straight = build(tmp_path / "b")
  rows = run_lib.train_steps(straight, 3, log=quiet)
  assert row["step"] == rows[2]["step"] == 2
  for k in ("losses", "losses_score", "losses_flow", "losses_logp"):
    assert row[k] == rows[2][k], k
  assert_same(state_of(resumed), state_of(straight))


def test_files_and_layout(tmp_path):
  """The meta pair every `snapshot_freq_for_preemption` steps and at the
  call's end, the numbered pair `step // snapshot_freq` every
  `snapshot_freq` steps; each stream `{optimizer, model, ema, step}` in
  torch's layouts (the score stream also its generators under "rng"),
  loadable with `weights_only=True`."""
  cfg = tiny_config(**{"training.snapshot_freq": 2,
                       "training.snapshot_freq_for_preemption": 5})
  tr = build(tmp_path, cfg)
  rows = run_lib.train_steps(tr, 3, log=quiet)
  assert all("save_seconds" in r for r in rows)
  names = sorted(os.path.relpath(os.path.join(d, f), tmp_path)
                 for d, _, fs in os.walk(tmp_path) for f in fs)
  assert names == ["checkpoints-meta/checkpoint.pth",
                   "checkpoints-meta/flow_checkpoint.pth",
                   "checkpoints/checkpoint_1.pth",
                   "checkpoints/flow_checkpoint_1.pth"]
  meta = torch.load(tmp_path / "checkpoints-meta/checkpoint.pth",
                    weights_only=True)
  numbered = torch.load(tmp_path / "checkpoints/flow_checkpoint_1.pth",
                        weights_only=True)
  assert set(meta) == {"optimizer", "model", "ema", "step", "rng"}
  assert set(numbered) == {"optimizer", "model", "ema", "step"}
  assert meta["step"] == 3 and numbered["step"] == 2
  assert_same(meta["model"], tr.score_model.state_dict())
  n_params = len(list(tr.score_model.parameters()))
  assert meta["ema"]["num_updates"] == 3
  assert meta["ema"]["decay"] == cfg.model.ema_rate
  assert len(meta["ema"]["shadow_params"]) == n_params
  opt = meta["optimizer"]
  assert sorted(opt["state"]) == list(range(n_params))
  assert set(opt["state"][0]) == {"step", "exp_avg", "exp_avg_sq"}
  assert float(opt["state"][0]["step"]) == 3.0
  assert opt["param_groups"][0]["params"] == list(range(n_params))
  assert opt["param_groups"][0]["betas"] == (cfg.optim.beta1, 0.99)


def test_missing_file_leaves_the_state(tmp_path, caplog):
  tr = build(tmp_path / "fresh")
  before = copy.deepcopy(state_of(tr))
  assert ckpt_lib.restore_checkpoint(
      tr.config, str(tmp_path / "none" / "checkpoint.pth"),
      tr.score_model, tr.score_opt, tr.score_ema) is None
  assert "No checkpoint found" in caplog.text
  assert_same(before, state_of(tr))


def test_optimizer_dropped_under_vesde_and_kept_for_the_flow(tmp_path):
  """Under VESDE a restore leaves the optimizer as it was, unless
  `keep_optimizer=True`, which the flow's stream always passes."""
  tr = build(tmp_path)
  run_lib.train_steps(tr, 1, log=quiet)
  ve = tiny_config()
  ve.training.sde = "vesde"
  fresh = build(tmp_path / "other")
  path = str(tmp_path / "checkpoints-meta" / "checkpoint.pth")
  ckpt_lib.restore_checkpoint(ve, path, fresh.score_model, fresh.score_opt,
                              fresh.score_ema)
  assert fresh.score_opt.count == 0
  assert all(not m.any() for m in fresh.score_opt.mu)
  assert_same(fresh.score_model.state_dict(), tr.score_model.state_dict())
  ckpt_lib.restore_checkpoint(ve, path, fresh.score_model, fresh.score_opt,
                              fresh.score_ema, keep_optimizer=True)
  assert fresh.score_opt.count == 1
  assert_same(fresh.score_opt.mu, tr.score_opt.mu)
  ve.flow.optim_reset = False
  run_lib.load_flow_model(ve, str(tmp_path), fresh.flow_model,
                          fresh.flow_opt, fresh.flow_ema)
  assert_same(fresh.flow_opt.nu, tr.flow_opt.nu)


def test_optim_reset_and_flow_optim_reset(tmp_path):
  tr = build(tmp_path)
  run_lib.train_steps(tr, 1, log=quiet)
  cfg = tiny_config()
  cfg.optim.reset = True
  cfg.flow.optim_reset = True
  again = build(tmp_path, cfg)
  assert again.step == 1
  for opt in (again.score_opt, again.flow_opt):
    assert opt.count == 0
    assert all(not m.any() for m in opt.mu + opt.nu)
  assert_same(again.score_ema.shadow, tr.score_ema.shadow)


def test_no_flow_checkpoint_resets_the_score_ema(tmp_path):
  """`run_lib.py:78-89`: with a flow configured but no flow meta
  checkpoint, the score EMA restarts from the parameters."""
  tr = build(tmp_path)
  run_lib.train_steps(tr, 2, log=quiet)
  assert not all(torch.equal(s, p) for s, p in
                 zip(tr.score_ema.shadow, tr.score_model.parameters()))
  os.remove(tmp_path / "checkpoints-meta" / "flow_checkpoint.pth")
  again = build(tmp_path)
  assert again.score_ema.num_updates == 0
  assert_same(again.score_ema.shadow, list(again.score_model.parameters()))
  assert_same(again.score_model.state_dict(), tr.score_model.state_dict())


def test_target_ckpt_reads_the_numbered_pair(tmp_path):
  cfg = tiny_config(**{"training.snapshot_freq": 1})
  tr = build(tmp_path, cfg)
  rows = run_lib.train_steps(tr, 2, log=quiet)
  cfg = tiny_config(**{"eval.target_ckpt": 1})
  s = run_lib.build_sampling(cfg, 2, device="cpu", workdir=str(tmp_path))
  assert s.step == 1 and rows
  state = torch.load(tmp_path / "checkpoints" / "checkpoint_1.pth",
                     weights_only=True)
  assert_same(list(s.score_model.parameters()),
              state["ema"]["shadow_params"])


def test_port_checkpoint_reads_through_the_jax_converters(tmp_path):
  """The port's files through `ncsnpp_params_from_torch` +
  `ema_state_dict_from_torch` and `wolf_state_from_torch` +
  `flow_ema_state_dict_from_torch`: the JAX score net (raw and EMA
  weights) and the JAX flow (encoder posterior, evaluation-mode forward
  on the same draws) give the port's outputs at 1e-5. The converters'
  shadow order (the state_dict's parameter keys) is `named_parameters()`'s
  order."""
  cfg = tiny_config()
  tr = build(tmp_path, cfg)
  run_lib.train_steps(tr, 2, log=quiet)
  score = torch.load(tmp_path / "checkpoints-meta" / "checkpoint.pth",
                     weights_only=True)
  flow = torch.load(tmp_path / "checkpoints-meta" / "flow_checkpoint.pth",
                    weights_only=True)
  jc = jax_configs.get_config("vp/CIFAR10/indm_nll")
  for k, v in TINY.items():
    tts._set(jc, k, v)
  jc.model.fused_groupnorm = False

  # the shadow order
  assert list(score["model"]) == [n for n, _ in
                                  tr.score_model.named_parameters()]
  assert jax_flow_convert.flow_param_keys(flow["model"]) == [
      n for n, _ in tr.flow_model.named_parameters()]

  module, _ = jax_create_model(jc, jax.random.PRNGKey(0))
  x = np.random.default_rng(3).uniform(-1, 1, tts.B * 192).astype(
      np.float32).reshape(tts.B, 8, 8, 3)
  labels = np.linspace(1.0, 900.0, tts.B).astype(np.float32)
  tr.score_model.eval()
  for sd, shadow in ((score["model"], None),
                     (ema_state_dict_from_torch(score, jc),
                      tr.score_ema.shadow)):
    params, _ = ncsnpp_params_from_torch(sd, jc)
    want = module.apply({"params": params}, jnp.asarray(x),
                        jnp.asarray(labels), train=False)
    port = copy.deepcopy(tr.score_model)
    if shadow is not None:
      tr.score_ema.copy_to(port)
    with torch.no_grad():
      got = port(tts._nchw(x), torch.from_numpy(labels))
    np.testing.assert_allclose(tts._nhwc(got), np.asarray(want), rtol=TOL,
                               atol=TOL)

  wolf = tts.TINY_WOLF
  fm = jax_fm.create_flow_model(jc)
  for sd in (flow["model"],
             jax_flow_convert.flow_ema_state_dict_from_torch(flow)):
    f_params, f_buffers = jax_flow_convert.wolf_state_from_torch(sd, jc,
                                                                 wolf)
    port = copy.deepcopy(tr.flow_model).eval()
    port.load_state_dict(sd)
    mu_j, logvar_j = fm.disc.apply(
        {"params": f_params["disc"], "batch_stats": f_buffers["batch_stats"]},
        jnp.asarray(x), train=False)
    with torch.no_grad():
      mu_t, logvar_t = port.discriminator(tts._nchw(x))
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(logvar_t.numpy(), np.asarray(logvar_j),
                               rtol=TOL, atol=TOL)
    z_j, ld_j = jax.jit(lambda v: jax_fm.flow_forward(
        jc, fm, f_params, f_buffers, v, train=False)[:2])(jnp.asarray(x))
    noise = tts.replay_flow_noise(fm, f_params, f_buffers,
                                  jax.random.PRNGKey(0), x.shape)
    z_t, ld_t = torch_fm.flow_forward(cfg, port, tts._nchw(x), train=False,
                                      noise=noise)
    np.testing.assert_allclose(tts._nhwc(z_t), np.asarray(z_j), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(ld_t.numpy(), np.asarray(ld_j), rtol=TOL,
                               atol=TOL)


TRAIN_ARGS = ["--device", "cpu", "--batch", "4",
              *(a for k, v in tts.TINY.items() if not k.startswith(
                  "training.")
                for a in ("--set", f"{k}={v}")),
              "--set", "model.dropout=0.1"]


def test_train_cli_resumes_bit_for_bit(tmp_path):
  """`python -m indm_torch.train --workdir W --steps 2`, then `--steps 1`,
  equals `--steps 3` in another work directory: the same losses and the
  same files' tensors."""
  a, b = tmp_path / "a", tmp_path / "b"
  train_cli.main([*TRAIN_ARGS, "--workdir", str(a), "--steps", "2"])
  (row,) = train_cli.main([*TRAIN_ARGS, "--workdir", str(a), "--steps", "1"])
  rows = train_cli.main([*TRAIN_ARGS, "--workdir", str(b), "--steps", "3"])
  assert row["losses"] == rows[2]["losses"]
  for name in ("checkpoint.pth", "flow_checkpoint.pth"):
    assert_same(torch.load(a / "checkpoints-meta" / name, weights_only=True),
                torch.load(b / "checkpoints-meta" / name, weights_only=True),
                name)


def test_train_cli_raises_without_a_card(tmp_path):
  if torch.cuda.is_available():
    pytest.skip("a card is present: the default device runs")
  args = [a for a in TRAIN_ARGS if a not in ("--device", "cpu")]
  with pytest.raises(RuntimeError, match="no CUDA card"):
    train_cli.main([*args, "--workdir", str(tmp_path), "--steps", "1"])
