"""The port's score-only training (`flow.model='identity'`) against the
JAX package: `losses.make_score_step_fn` in its continuous, DDPM and SMLD
modes with one and two micro-batches, the discrete losses, Adam beside
AdamW, and the training CLIs without a flow; the refusals that remain,
each shown to fail in the JAX package too.

Geometry: the tiny score net of `tests/test_torch_train_step.py` (8x8
images, nf 8, dropout off: threefry masks cannot be replayed) with the
JAX weights carried across by `indm_torch.convert`; GroupNorm through the
per-group statistics on both sides (`model.fused_groupnorm` off), which
keeps the JAX compiles short: kernels 1 and 2's plain versions compute the
variance as E[x^2] - mean^2, as the Pallas kernels do, and are held
against those in `tests/test_torch_group_norm.py`; the card holds them in
a score-only step against the CPU (`chip_smoke.py`, phase 15a). The JAX
step runs once a mode with an optimizer that records the gradients it is
given; every draw of that step is rebuilt from its key tree and handed to
the port.
Losses within 1e-5; each gradient tensor within 1e-4 of its largest
value, floored at 1e-4 of the net's largest gradient (`chip_smoke.py`'s
phase 11 criterion: the SMLD loss weights by sigma^2, up to 2500, so an
element's error scales with its tensor's largest value, not with its
own); the optimizers' updates on identical gradients within 1e-6 of
optax's.
"""

import copy
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_train_step as tts
from indm_torch import configs as torch_configs
from indm_torch import convert
from indm_torch import ema as torch_ema
from indm_torch import losses as torch_losses
from indm_torch import main as main_cli
from indm_torch import optim as torch_optim
from indm_torch import run_lib
from indm_torch import sde as torch_sde
from indm_torch import train as train_cli
from indm_torch.models.ncsnpp import NCSNpp
from indm_tpu import configs as jax_configs
from indm_tpu import losses as jax_losses
from indm_tpu import sde as jax_sde
from indm_tpu import state as jax_state
from indm_tpu.models.registry import get_model as jax_get_model
from torch_threads import one_torch_thread  # noqa: F401

NET = {"data.image_size": 8, "model.nf": 8, "model.num_res_blocks": 1,
       "model.ch_mult": (1, 1), "model.attn_resolutions": (4,),
       "model.init_scale": 1.0, "model.dropout": 0.0,
       "model.fused_groupnorm": False, "flow.model": "identity"}
# the batch: 5 images, so that two micro-batches of 2 drop one
B = 5
GRAD_RTOL = 1e-4
MODES = {
    # continuous: the NLL config's likelihood weighting, importance sampling
    "continuous": {},
    "ddpm": {"training.continuous": False,
             "training.likelihood_weighting": False,
             "training.importance_sampling": False},
    # SMLD: VESDE's noise levels with the same (positional) net
    "smld": {"training.sde": "vesde", "training.continuous": False,
             "training.likelihood_weighting": False,
             "training.importance_sampling": False},
}


def configs(mode, **leaves):
  jc = jax_configs.get_config("vp/CIFAR10/indm_nll")
  tc = torch_configs.get_config("vp/CIFAR10/indm_nll")
  for c in (jc, tc):
    for k, v in {**NET, **MODES[mode], **leaves}.items():
      tts._set(c, k, v)
  return jc, tc


def replay(jc, state_rng, shape):
  """The draws of one JAX score step from the state's key: split off the
  step key, split it per micro-batch, then the loss's own split. Returns
  the port's `ScoreNoise` per micro-batch and, for the continuous loss,
  JAX's (t, Z) per micro-batch."""
  n = jc.optim.num_micro_batch
  _, step_rng = jax.random.split(state_rng)
  rngs = [step_rng] if n == 1 else list(jax.random.split(step_rng, n))
  mb = (shape[0] // n,) + tuple(shape[1:])
  out, times = [], []
  j_sde = jax_sde.get_sde(jc)
  for r in rngs:
    if jc.training.continuous:
      _, rng_t, rng_z, _, _, _ = jax.random.split(r, 6)
      out.append(torch_losses.ScoreNoise(
          u_t=torch.from_numpy(np.array(jax.random.uniform(rng_t, mb[:1]))),
          z=tts._nchw(jax.random.normal(rng_z, mb))))
      t, z_norm = j_sde.get_diffusion_time(
          rng_t, mb[0], j_sde.get_t_min(None, False),
          jc.training.importance_sampling)
      times.append((np.array(t), np.array(z_norm)))
    else:
      rng_l, rng_z, _ = jax.random.split(r, 3)
      labels = jax.random.randint(rng_l, mb[:1], 0, jc.model.num_scales)
      out.append(torch_losses.ScoreNoise(
          labels=torch.from_numpy(np.array(labels)).long(),
          z=tts._nchw(jax.random.normal(rng_z, mb))))
  return out, times


@functools.lru_cache(maxsize=None)
def jax_variables():
  """The tiny net's initial variables from key 0, as
  `indm_tpu.models.create_model` draws them, made once for every mode (the
  modes share the net) and under `jax.jit`: run eagerly, each operation
  of the init compiles on its own."""
  jc, _ = configs("continuous")
  module = jax_get_model(jc.model.name)(jc)
  x = jnp.zeros((2, 8, 8, 3), jnp.float32)
  t = jnp.ones((2,), jnp.float32)

  def init(rng):
    p_rng, d_rng = jax.random.split(rng)
    return module.init({"params": p_rng, "dropout": d_rng}, x, t,
                       train=False)

  return jax.jit(init)(jax.random.PRNGKey(0))


def jax_step(jc, times):
  """The JAX score step once with a gradient-recording optimizer, its SDE
  handing out `times` (each micro-batch's (t, Z)) where the continuous
  loss draws them: (module variables, state before, state after,
  per-example losses, batch)."""
  module = jax_get_model(jc.model.name)(jc)
  variables = jax_variables()
  opt = tts._record_grads()
  buffers = {k: v for k, v in variables.items() if k != "params"}
  ss = jax_state.init_train_state(jc, variables["params"], buffers, opt,
                                  jax.random.PRNGKey(2))
  sde = jax_sde.get_sde(jc)
  given = iter(times)
  sde.get_diffusion_time = lambda *a: tuple(map(jnp.asarray, next(given)))
  step = jax_losses.make_score_step_fn(jc, sde, module, opt)
  batch = np.random.default_rng(4).uniform(-1, 1, (B, 8, 8, 3)).astype(
      np.float32)
  ss2, losses = jax.jit(step)(ss, jnp.asarray(batch))
  return variables, ss, ss2, np.asarray(losses), batch


# each case compiles a JAX step (two micro-batches twice the graph): two
# micro-batches once, in the continuous loss, whose diffusion times are
# drawn a micro-batch at a time; the discrete losses share its loop
@pytest.mark.parametrize("mode,micro,optimizer", [
    ("continuous", 1, "AdamW"), ("continuous", 2, "Adam"),
    ("ddpm", 1, "Adam"), ("smld", 1, "AdamW")])
def test_score_step_matches_jax(mode, micro, optimizer):
  """One score-only step on the JAX step's batch and replayed draws: the
  per-example losses (2 x 2 of the 5 images with two micro-batches, the
  remainder dropped), the gradients summed over the micro-batches of
  their mean losses, before any update; then the config's optimizer and
  the EMA moved the parameters. Both continuous losses take the same
  diffusion times and weight, JAX's computed eagerly from the step's key
  (`test_torch_losses.py` holds the port's formula to JAX's at 1e-6):
  compiled in the step, XLA computes the importance distribution's t,
  whose log(1 - exp(-ib(t_min))) keeps about one digit, to other bits,
  and the net embeds t * 999 through sines of up to 999 radians."""
  jc, tc = configs(mode, **{"optim.num_micro_batch": micro,
                            "optim.optimizer": optimizer})
  shape = (B, 8, 8, 3)
  noise, times = replay(jc, jax_state.init_train_state(
      jc, {}, {}, tts._record_grads(), jax.random.PRNGKey(2)).rng, shape)
  variables, ss, ss2, losses_j, batch = jax_step(jc, times)
  model = NCSNpp(tc)
  model.load_state_dict(convert.score_state_dict_from_jax(
      tts._np(variables["params"]), tc), strict=True)
  model.train()
  opt = torch_optim.make_optimizer(tc, model.parameters())
  assert type(opt) is {"Adam": torch_optim.Adam,
                       "AdamW": torch_optim.AdamW}[optimizer]
  ema = torch_ema.EMA(opt.params, tc.model.ema_rate)
  before = [p.detach().clone() for p in opt.params]
  t_sde = torch_sde.get_sde(tc)
  given = iter(times)
  t_sde.get_diffusion_time = lambda *a, **k: tuple(
      map(torch.from_numpy, next(given)))
  step = torch_losses.make_score_step_fn(tc, t_sde, model, opt, ema)
  (losses_t,) = step(tts._nchw(batch), noise)
  assert losses_t.shape == losses_j.shape == ((B // micro) * micro,)
  np.testing.assert_allclose(losses_t.numpy(), losses_j, rtol=1e-5,
                             atol=1e-5)
  want = convert.score_state_dict_from_jax(tts._np(ss2.opt_state["g"]), tc)
  grads = dict(model.named_parameters())
  assert len(grads) > 50
  floor = 1e-4 * max(want[k].abs().max().item() for k in grads)
  for name, p in grads.items():
    scale = max(want[name].abs().max().item(), floor)
    err = (p.grad - want[name]).abs().max().item()
    assert err <= GRAD_RTOL * scale, (name, err, scale)
  assert all(not torch.equal(a, b) for a, b in zip(before, opt.params))
  assert ema.num_updates == 1 and opt.count == 1


def _grads_and_params(seed):
  g = np.random.default_rng(seed)
  params = {"w": g.normal(size=(6, 5)).astype(np.float32),
            "b": g.normal(size=(5,)).astype(np.float32)}
  grads = [{k: (g.normal(size=v.shape) * s).astype(np.float32)
            for k, v in params.items()} for s in (0.3, 3.0, 0.01)]
  return params, grads


@pytest.mark.parametrize("optimizer,warmup,clip", [
    ("Adam", 0, 1.0), ("Adam", 2, -1.0), ("AdamW", 0, 1.0)])
def test_optimizer_matches_optax_on_identical_grads(optimizer, warmup, clip):
  """Three updates of the port's optimizer against
  `indm_tpu.state.make_optimizer`'s optax chain on the same gradients:
  Adam's L2 weight decay added to the clipped gradient and b2 = 0.999,
  AdamW's decoupled decay and b2 = 0.99; the clip (one of the three
  gradients over it) and the warmup; 1e-6."""
  jc, tc = configs("continuous", **{"optim.optimizer": optimizer,
                                    "optim.warmup": warmup,
                                    "optim.grad_clip": clip,
                                    "optim.weight_decay": 0.05})
  params, grads = _grads_and_params(1)
  opt_j = jax_state.make_optimizer(jc)
  state_j, p_j = opt_j.init(params), params
  ps = [torch.nn.Parameter(torch.from_numpy(params[k].copy()))
        for k in ("w", "b")]
  opt_t = torch_optim.make_optimizer(tc, ps)
  for g in grads:
    updates, state_j = opt_j.update(g, state_j, p_j)
    p_j = optax.apply_updates(p_j, updates)
    for p, k in zip(ps, ("w", "b")):
      p.grad = torch.from_numpy(g[k].copy())
    opt_t.step()
    for p, k in zip(ps, ("w", "b")):
      np.testing.assert_allclose(p.detach().numpy(), np.asarray(p_j[k]),
                                 rtol=1e-6, atol=1e-6)


def test_adam_state_dict_is_torch_adams_layout():
  """Adam's checkpoint in `torch.optim.Adam`'s layout: torch's Adam (b2
  0.999, no decay, no clip) takes the port's state after two updates and
  continues to the port's third update's parameters; the port takes
  torch's state back."""
  _, tc = configs("continuous", **{"optim.optimizer": "Adam",
                                   "optim.weight_decay": 0.0,
                                   "optim.grad_clip": -1.0,
                                   "optim.warmup": 0})
  params, grads = _grads_and_params(2)
  ps = [torch.nn.Parameter(torch.from_numpy(params["w"].copy()))]
  ours = torch_optim.make_optimizer(tc, ps)
  for g in grads[:2]:
    ps[0].grad = torch.from_numpy(g["w"].copy())
    ours.step()
  qs = [torch.nn.Parameter(ps[0].detach().clone())]
  theirs = torch.optim.Adam(qs, lr=tc.optim.lr, betas=(tc.optim.beta1,
                                                       0.999),
                            eps=tc.optim.eps)
  # a copy, as a checkpoint file holds it: state_dict hands out the moments
  # themselves, which torch's load would share
  theirs.load_state_dict(copy.deepcopy(ours.state_dict()))
  for p in (ps[0], qs[0]):
    p.grad = torch.from_numpy(grads[2]["w"].copy())
  ours.step()
  theirs.step()
  torch.testing.assert_close(qs[0].detach(), ps[0].detach(), rtol=1e-6,
                             atol=1e-6)
  back = torch_optim.make_optimizer(tc, [torch.nn.Parameter(qs[0].detach())])
  back.load_state_dict(copy.deepcopy(theirs.state_dict()))
  assert back.count == 3
  torch.testing.assert_close(back.nu[0], ours.nu[0])


@pytest.mark.parametrize("mode", ["ddpm", "smld"])
def test_discrete_losses_match_jax(mode):
  """`get_ddpm_loss_fn` and `get_smld_loss_fn` with a stand-in net that
  sees the labels, JAX's labels and normals replayed: 1e-5."""
  jc, tc = configs(mode)
  js, ts = jax_sde.get_sde(jc), torch_sde.get_sde(tc)
  make = {"ddpm": (jax_losses.get_ddpm_loss_fn,
                   torch_losses.get_ddpm_loss_fn),
          "smld": (jax_losses.get_smld_loss_fn,
                   torch_losses.get_smld_loss_fn)}[mode]
  batch = np.random.default_rng(5).normal(size=(4, 8, 8, 3)).astype(
      np.float32)
  rng = jax.random.PRNGKey(6)
  net_j = lambda x, labels, rng=None: x * 0.3 + 1e-3 * labels[:, None, None,
                                                              None]
  net_t = lambda x, labels, g=None: x * 0.3 + 1e-3 * labels[:, None, None,
                                                            None]
  l_j = make[0](jc, js, True)(net_j, jnp.asarray(batch), rng)
  rng_l, rng_z, _ = jax.random.split(rng, 3)
  labels = torch.from_numpy(np.array(jax.random.randint(
      rng_l, (4,), 0, js.N))).long()
  l_t = make[1](tc, ts)(net_t, tts._nchw(batch), labels=labels,
                        z=tts._nchw(jax.random.normal(rng_z, batch.shape)))
  np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), rtol=1e-5)


@pytest.mark.parametrize("case", ["discrete-on-subvp",
                                  "discrete-with-likelihood-weighting"])
def test_score_step_refusals_fail_in_jax_too(case):
  leaves = ({"training.sde": "subvpsde", "training.continuous": False,
             "training.likelihood_weighting": False}
            if case == "discrete-on-subvp" else
            {"training.continuous": False})
  jc, tc = configs("continuous", **leaves)
  with pytest.raises((ValueError, AssertionError)):
    jax_losses.make_score_step_fn(jc, jax_sde.get_sde(jc), None, None)
  with pytest.raises(ValueError) as err:
    torch_losses.make_score_step_fn(tc, torch_sde.get_sde(tc), None, None,
                                    None)
  assert ("subVPSDE" if case == "discrete-on-subvp" else
          "Likelihood weighting") in str(err.value)


def test_joint_micro_batches_stay_refused():
  """The joint steps take micro-batches now (`test_torch_joint_micro.py`
  holds them against JAX). What stays refused is a batch they cannot cut
  into `optim.num_micro_batch` contiguous chunks: the JAX steps'
  reshape fails there, and unlike the score-only step (which drops the
  remainder, `B` = 5 above) the joint step refuses it, naming the leaf."""
  _, tc = configs("continuous", **{"optim.num_micro_batch": 2,
                                   "flow.model": "wolf",
                                   "flow.nblocks": "2-2",
                                   "flow.intermediate_dim": 8})
  from indm_torch import run_lib
  tr = run_lib.build_training(tc, device="cpu")
  batch = torch.zeros(3, 3, 8, 8)
  with pytest.raises(ValueError, match="num_micro_batch"):
    tr.step_fn(batch)
  metrics = tr.step_fn(torch.zeros(4, 3, 8, 8), generator=tr.generator,
                       host_rng=tr.host_rng)
  assert [m.shape for m in metrics] == [(4,)] * 4


def _tiny_args(*extra):
  args = []
  for k, v in {**NET, "training.batch_size": 4}.items():
    args += ["--set", f"{k}={v}"]
  for item in extra:
    args += ["--set", item]
  return args


def test_main_trains_score_only_and_resumes(tmp_path, caplog):
  """`python -m indm_torch.main --mode train --set flow.model=identity`
  on the CPU: the score-only step from step 0 to `training.n_iters`, one
  log line a step ("training loss mean ... std"), only the score stream's
  checkpoints; a second call resumes from the meta checkpoint; under
  `optim.num_micro_batch=2` with Adam, two steps more."""
  common = ["--mode", "train", "--config", "vp/CIFAR10/indm_nll", "--device",
            "cpu", "--workdir", str(tmp_path)]
  sets = _tiny_args("training.log_freq=1", "training.snapshot_sampling=false",
                    "eval.enable_bpd=false", "optim.reset=false")
  caplog.set_level("INFO")
  tr = main_cli.main([*common, *sets, "--set", "training.n_iters=1"])
  assert tr.flow_model is None and tr.step == 2
  lines = [r.getMessage() for r in caplog.records]
  assert sum("training loss mean" in l and "std" in l for l in lines) == 2
  assert sorted(os.listdir(tmp_path / "checkpoints-meta")) == [
      "checkpoint.pth"]
  assert sorted(os.listdir(tmp_path / "checkpoints")) == [
      "checkpoint_0.pth"]
  caplog.clear()
  tr = main_cli.main([*common, *sets, "--set", "training.n_iters=2",
                      "--set", "optim.num_micro_batch=2", "--set",
                      "optim.optimizer=Adam"])
  lines = [r.getMessage() for r in caplog.records]
  assert "Starting training loop at step 2." in lines
  assert tr.step == 3 and isinstance(tr.score_opt, torch_optim.Adam)


def test_train_cli_score_only_steps(tmp_path, capsys):
  """`python -m indm_torch.train --set flow.model=identity --steps 2
  --device cpu`: two score-only steps, each line the loss's mean; a
  second call resumes from the work directory."""
  args = ["--device", "cpu", "--batch", "4", "--workdir", str(tmp_path),
          *_tiny_args()]
  rows = train_cli.main([*args, "--steps", "2"])
  assert [r["step"] for r in rows] == [0, 1]
  assert all(np.isfinite(r["losses"]) for r in rows)
  assert capsys.readouterr().out.count("training loss mean") == 2
  (row,) = train_cli.main([*args, "--steps", "1"])
  assert row["step"] == 2
  assert not (tmp_path / "checkpoints-meta" / "flow_checkpoint.pth").exists()


def test_score_only_snapshot_samples(tmp_path, monkeypatch):
  """The training loop without a flow at a snapshot: snapshot sampling
  through the PC sampler (`sampling.method=pc`, 4 scales) of the score
  net's EMA into `samples/iter_1/` with its PNG grid, then the FID call
  (stubbed: `tests/test_torch_fid.py` holds it)."""
  monkeypatch.setattr(run_lib.evaluation, "compute_fid_and_is",
                      lambda *a, **k: {"fid": 0.0})
  tc = configs("continuous")[1]
  for k, v in {"training.batch_size": 4, "training.n_iters": 1,
               "training.snapshot_freq_for_preemption": 1,
               "training.log_freq": 1, "eval.enable_bpd": False,
               "eval.num_samples": 2, "sampling.batch_size": 2,
               "sampling.method": "pc", "model.num_scales": 50,
               "sampling.num_scales": 4}.items():
    tts._set(tc, k, v)
  rows = []
  run_lib.train(tc, str(tmp_path), device="cpu", log=lambda *a: None,
                on_step=rows.append)
  snaps = [r for r in rows if "snapshot" in r]
  assert [r["step"] for r in snaps] == [0, 1]
  d = tmp_path / "samples" / "iter_1"
  assert (d / "samples_0.png").exists() and (d / "samples_0.npz").exists()
  with np.load(d / "samples_0.npz") as z:
    assert z["samples"].shape == (2, 8, 8, 3)
