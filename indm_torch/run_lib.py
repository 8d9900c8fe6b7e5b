"""Training, evaluation and sampling orchestration (counterpart of
`indm_tpu/run_lib.py:53-142, 168-494`): the models restored from a work
directory's checkpoints (`load_model`, `load_flow_model`), the joint
training step on the training split (`data.load_arrays`) with the
checkpoints written as the JAX loop writes them, the training loop to
`training.n_iters` (`train`) with its log lines, bits/dim and snapshot
sampling with FID, the eval-mode score function and flow, one sampling
round (ODE or PC, as the config says), the latent data mean of the VE
prior (`eval.data_mean`), and `evaluate`: bits/dim of the checkpoint on the
test split, then sampling rounds and their FID, IS and KID.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import os
import time
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from indm_torch import checkpoint as ckpt_lib
from indm_torch import data as data_lib
from indm_torch import ema as ema_lib
from indm_torch import evaluation
from indm_torch import joint as joint_lib
from indm_torch import likelihood as likelihood_lib
from indm_torch import losses as losses_lib
from indm_torch import optim as optim_lib
from indm_torch import sampling as sampling_lib
from indm_torch import sampling_io
from indm_torch import sde as sde_lib
from indm_torch.flows.flow_model import create_flow_model, flow_forward
from indm_torch.models.registry import create_model, get_score_fn


def set_f32_numerics():
  """Full f32 convolutions and matmuls on the card, as the JAX package
  computes in f32: cuDNN's TF32 default is turned off."""
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False


def check_device(device) -> torch.device:
  """The device to run on; a CUDA device must exist (nothing falls back
  to the CPU)."""
  device = torch.device(device)
  if device.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("no CUDA card is available; pass --device cpu to run "
                       "on the CPU")
  return device


def checkpoint_paths(workdir: str, config) -> dict:
  """The two streams' files: the rolling meta pair, or with
  `eval.target_ckpt` k != -1 the numbered pair k (`run_lib.py:68-73,
  134-139`)."""
  meta = os.path.join(workdir, "checkpoints-meta")
  k = config.eval.target_ckpt
  if k == -1:
    return {"score": os.path.join(meta, "checkpoint.pth"),
            "flow": os.path.join(meta, "flow_checkpoint.pth")}
  numbered = os.path.join(workdir, "checkpoints")
  return {"score": os.path.join(numbered, f"checkpoint_{k}.pth"),
          "flow": os.path.join(numbered, f"flow_checkpoint_{k}.pth")}


def load_model(config, workdir: str, score_model, score_opt, score_ema
               ) -> Optional[dict]:
  """Restore the score net's stream into the given objects
  (`run_lib.py:53-91`); `score_opt` may be None (evaluation). Then
  `optim.reset` starts the optimizer afresh, and with a flow configured
  but no flow meta checkpoint the EMA is reset to the parameters. Returns
  the checkpoint's dict, or None when there is none."""
  state = ckpt_lib.restore_checkpoint(
      config, checkpoint_paths(workdir, config)["score"], score_model,
      score_opt, score_ema)
  if config.optim.reset and score_opt is not None:
    score_opt.reset()
  if config.flow.model != "identity":
    if not os.path.exists(os.path.join(workdir, "checkpoints-meta",
                                       "flow_checkpoint.pth")):
      logging.info("No flow checkpoints, so reset score ema!!")
      score_ema.reset(score_model.parameters())
    else:
      logging.info("There exists flow checkpoints, so keep score ema!!")
  return state


def load_vdm_aux(config, workdir: Optional[str], seed: int,
                 device="cuda") -> Optional[dict]:
  """The VDM's extra state (`indm_tpu/run_lib.py:94-121`), None for any
  other net: `models.vdm.VDMAux` (gamma_minmax and the noise schedule)
  drawn from `seed`, with its own optimizer and EMA, restored from
  `<workdir>/checkpoints-meta/vdm_aux_checkpoint.pth` where that exists.
  As in the JAX package nothing trains it (`get_gamma_fn` has no caller):
  it rides through training unchanged and is saved with the meta pair.
  Returns {"model", "optimizer", "ema", "meta", "step"}."""
  if config.model.name != "vdm":
    return None
  from indm_torch.models.vdm import VDMAux
  model = VDMAux(generator=torch.Generator().manual_seed(seed)).to(device)
  opt = optim_lib.make_optimizer(config, model.parameters())
  ema = ema_lib.EMA(opt.params, config.model.ema_rate)
  meta = (None if workdir is None else
          os.path.join(workdir, "checkpoints-meta", "vdm_aux_checkpoint.pth"))
  state = (None if meta is None else
           ckpt_lib.restore_checkpoint(config, meta, model, opt, ema))
  return {"model": model, "optimizer": opt, "ema": ema, "meta": meta,
          "step": 0 if state is None else state["step"]}


def save_vdm_aux(aux: dict) -> None:
  """`load_vdm_aux`'s state to its meta checkpoint (`indm_tpu/run_lib.py:
  289-291`)."""
  ckpt_lib.save_checkpoint(aux["meta"], ckpt_lib.stream_state(
      aux["model"], aux["optimizer"], aux["ema"], aux["step"]))


def load_flow_model(config, workdir: str, flow_model, flow_opt, flow_ema
                    ) -> Optional[dict]:
  """Restore the flow's stream (`run_lib.py:128-142`), its optimizer
  always kept; then `flow.optim_reset`."""
  state = ckpt_lib.restore_checkpoint(
      config, checkpoint_paths(workdir, config)["flow"], flow_model,
      flow_opt, flow_ema, keep_optimizer=True)
  if config.flow.optim_reset and flow_opt is not None:
    flow_opt.reset()
  return state


def make_eval_fns(config, sde, score_model, flow_model,
                  generator: Optional[torch.Generator] = None,
                  prior_eps: Optional[torch.Tensor] = None):
  """(score_fn, flow_inverse); flow_inverse is None without a flow.
  `prior_eps` replaces the flow prior's draw of epsilon."""
  score_fn = get_score_fn(config, sde, score_model,
                          continuous=config.training.continuous)
  if flow_model is None:
    return score_fn, None

  def flow_inverse(x):
    return flow_forward(config, flow_model, x, reverse=True,
                        generator=generator, prior_eps=prior_eps)[0]

  return score_fn, flow_inverse


class Sampling(NamedTuple):
  sde: sde_lib.SDE
  score_model: torch.nn.Module
  flow_model: Optional[torch.nn.Module]
  sampling_fn: object
  step: int = 0                     # the checkpoint's step


def build_sampling(config, batch: int, device="cuda", seed: Optional[int] = None,
                   workdir: Optional[str] = None) -> Sampling:
  """Models in eval mode and the configured sampler for `batch` images, all
  on `device`. Weights are drawn from `seed` (default `config.seed`; the
  score net from seed, the flow from seed + 1), then, with `workdir`,
  restored from its checkpoints (`load_model`, `load_flow_model`): the
  score net takes its EMA when `eval.score_ema` is set, the flow its raw
  parameters, as the JAX package evaluates (`run_lib.py:168-189`). The
  models' `step` attribute is the checkpoint's step (0 without one)."""
  device = check_device(device)
  if device.type == "cuda":
    set_f32_numerics()
  seed = config.seed if seed is None else seed
  sde = sde_lib.get_sde(config)
  score_model = create_model(config, seed=seed, device=device)
  flow_model = create_flow_model(config, seed=seed + 1, device=device)
  step = 0
  if workdir is not None:
    score_ema = ema_lib.EMA(score_model.parameters(), config.model.ema_rate)
    state = load_model(config, workdir, score_model, None, score_ema)
    step = 0 if state is None else state["step"]
    if config.eval.score_ema:
      score_ema.copy_to(score_model)
    if flow_model is not None:
      load_flow_model(config, workdir, flow_model, None,
                      ema_lib.EMA(flow_model.parameters(),
                                  config.flow.ema_rate))
  shape = (batch, config.data.num_channels, config.data.image_size,
           config.data.image_size)
  sampling_fn = sampling_lib.get_sampling_fn(
      config, sde, shape, data_lib.get_data_inverse_scaler(config),
      config.sampling.truncation_time, device=device)
  return Sampling(sde, score_model, flow_model, sampling_fn, step)


def sample_round(config, s: Sampling,
                 generator: Optional[torch.Generator] = None,
                 prior_noise: Optional[torch.Tensor] = None,
                 prior_eps: Optional[torch.Tensor] = None, step_noise=None,
                 data_mean: Optional[torch.Tensor] = None,
                 before_data: Optional[torch.Tensor] = None,
                 final_time: float = 0.0):
  """One round: (before [B,H,W,C], after [B,H,W,C], the plain PC loop's
  step-(N-2) mean [B,H,W,C] or None, nfe). The prior sample, the PC
  sampler's step noise (`step_noise(k)`, see `sampling.get_pc_sampler`)
  and the flow prior's epsilon are drawn from `generator` unless given;
  `data_mean` [C,H,W] centres the prior; `before_data` (NCHW, the model's
  scale) and `final_time` are the denoise search's and the extra steps'
  resume (`indm_tpu/run_lib.py:339-375`)."""
  score_fn, flow_inverse = make_eval_fns(config, s.sde, s.score_model,
                                         s.flow_model, generator, prior_eps)
  kw = {} if step_noise is None else {"step_noise": step_noise}
  if data_mean is not None:
    kw["data_mean"] = data_mean
  return s.sampling_fn(score_fn, flow_inverse,
                       temperature=config.sampling.temperature,
                       generator=generator, prior_noise=prior_noise,
                       before_data=before_data, final_time=final_time, **kw)


@dataclasses.dataclass
class Training:
  config: object
  device: torch.device
  sde: sde_lib.SDE
  score_model: torch.nn.Module
  flow_model: Optional[torch.nn.Module]    # None: flow.model='identity'
  score_opt: optim_lib.AdamW
  flow_opt: Optional[optim_lib.AdamW]
  score_ema: ema_lib.EMA
  flow_ema: Optional[ema_lib.EMA]
  step_fn: Callable
  batches: data_lib.TrainBatches
  np_rng: np.random.Generator       # dequantisation noise
  host_rng: np.random.Generator     # the flow estimator's n
  generator: torch.Generator        # every draw on the device
  workdir: Optional[str] = None     # where checkpoints are read and written
  step: int = 0                     # steps taken, the checkpoints' step
  restore_seconds: float = 0.0      # host seconds of the restore
  vdm_aux: Optional[dict] = None    # `load_vdm_aux`'s state (model.name vdm)


def rng_state(tr: Training) -> dict:
  """Every generator's state and the batches' place in their epoch, for
  the score stream's `"rng"` entry."""
  return {"np_rng": tr.np_rng.bit_generator.state,
          "host_rng": tr.host_rng.bit_generator.state,
          "generator": tr.generator.get_state(),
          "batches": tr.batches.state_dict()}


def load_rng_state(tr: Training, state: dict):
  tr.np_rng.bit_generator.state = state["np_rng"]
  tr.host_rng.bit_generator.state = state["host_rng"]
  tr.generator.set_state(state["generator"].cpu())
  tr.batches.load_state_dict(state["batches"])


def save_training(tr: Training, numbered: Optional[int] = None):
  """Write the streams: the meta pair, or with `numbered` = k
  `checkpoints/checkpoint_{k}.pth` and `flow_checkpoint_{k}.pth` (the
  score stream alone without a flow); the meta pair also the VDM's
  auxiliary state, where there is one."""
  if numbered is None:
    d, name = os.path.join(tr.workdir, "checkpoints-meta"), ""
  else:
    d, name = os.path.join(tr.workdir, "checkpoints"), f"_{numbered}"
  ckpt_lib.save_checkpoint(
      os.path.join(d, f"checkpoint{name}.pth"),
      ckpt_lib.stream_state(tr.score_model, tr.score_opt, tr.score_ema,
                            tr.step, rng=rng_state(tr)))
  if tr.vdm_aux is not None and numbered is None:
    save_vdm_aux(tr.vdm_aux)
  if tr.flow_model is None:
    return
  ckpt_lib.save_checkpoint(
      os.path.join(d, f"flow_checkpoint{name}.pth"),
      ckpt_lib.stream_state(tr.flow_model, tr.flow_opt, tr.flow_ema,
                            tr.step))


def build_training(config, device="cuda", seed: Optional[int] = None,
                   workdir: Optional[str] = None) -> Training:
  """Both nets in train mode with weights drawn from `seed` (default
  `config.seed`; the score net from seed, the flow from seed + 1), their
  optimizers and EMAs, the VDM's auxiliary state (`load_vdm_aux`, from seed
  + 7), the joint step, and the batches of the training
  split (`data.TrainBatches`), all on `device`; under
  `flow.model='identity'` the score net alone with the score-only step
  (`losses.make_score_step_fn`). With `workdir` the state
  is then restored from its checkpoints (`load_model`, `load_flow_model`;
  the generators and the batches' place from the score stream), and
  `train_steps` writes them there."""
  device = check_device(device)
  if device.type == "cuda":
    set_f32_numerics()
  seed = config.seed if seed is None else seed
  sde = sde_lib.get_sde(config)
  score_model = create_model(config, seed=seed, device=device).train()
  flow_model = create_flow_model(config, seed=seed + 1, device=device)
  score_opt = optim_lib.make_optimizer(config, score_model.parameters())
  score_ema = ema_lib.EMA(score_opt.params, config.model.ema_rate)
  if flow_model is None:
    flow_opt = flow_ema = None
    step_fn = losses_lib.make_score_step_fn(config, sde, score_model,
                                            score_opt, score_ema)
  else:
    flow_model.train()
    flow_opt = optim_lib.make_optimizer(config, flow_model.parameters(),
                                        lr=config.flow.lr)
    flow_ema = ema_lib.EMA(flow_opt.params, config.flow.ema_rate)
    step_fn = joint_lib.make_joint_step_fn(config, sde, score_model,
                                           flow_model, score_opt, flow_opt,
                                           score_ema, flow_ema)
  batches = data_lib.TrainBatches(data_lib.load_arrays(config)[0],
                                  config.training.batch_size,
                                  config.data.random_flip, config.seed)
  generator = torch.Generator(device=device).manual_seed(seed + 2)
  tr = Training(config, device, sde, score_model, flow_model, score_opt,
                flow_opt, score_ema, flow_ema, step_fn, batches,
                np.random.default_rng(config.seed),
                np.random.default_rng(seed + 3), generator, workdir)
  tr.vdm_aux = load_vdm_aux(config, workdir, seed + 7, device)
  if workdir is not None:
    t0 = time.perf_counter()
    state = load_model(config, workdir, score_model, score_opt, score_ema)
    if flow_model is not None:
      load_flow_model(config, workdir, flow_model, flow_opt, flow_ema)
    if state is not None:
      tr.step = state["step"]
      load_rng_state(tr, state["rng"])
    if device.type == "cuda":
      torch.cuda.synchronize(device)
    tr.restore_seconds = time.perf_counter() - t0
  return tr


def next_batch(tr: Training) -> torch.Tensor:
  """The next batch, uniformly dequantised ((255 x + u) / 256) and scaled,
  as an NCHW float32 tensor on the training device."""
  batch = next(tr.batches)
  batch = (255.0 * batch + tr.np_rng.random(batch.shape,
                                            dtype=np.float32)) / 256.0
  batch = data_lib.get_data_scaler(tr.config)(batch)
  return torch.from_numpy(np.ascontiguousarray(
      batch.transpose(0, 3, 1, 2))).to(tr.device)


def _step(tr: Training) -> dict:
  """One step from step `tr.step`, joint or (without a flow) score-only:
  its row, the means of its losses (the four of `joint.METRICS`, or
  "losses" alone), the per-example losses (CPU) and the seconds from the
  batch's upload to the losses on the host; then `tr.step` counts it."""
  if tr.device.type == "cuda":
    torch.cuda.synchronize(tr.device)
  t0 = time.perf_counter()
  metrics = tr.step_fn(next_batch(tr), generator=tr.generator,
                       host_rng=tr.host_rng)
  means = [m.mean().item() for m in metrics]
  row = dict(zip(joint_lib.METRICS, means), step=tr.step,
             seconds=time.perf_counter() - t0,
             per_example=[m.cpu() for m in metrics])
  tr.step += 1
  return row


def _save(tr: Training, last: bool) -> float:
  """After a step that brings the count to s: the meta pair when s is a
  multiple of `training.snapshot_freq_for_preemption` or `last`, the
  numbered pair s // `training.snapshot_freq` when s is a multiple of
  `training.snapshot_freq` or `training.n_iters`; returns the host
  seconds."""
  t = tr.config.training
  t0 = time.perf_counter()
  if tr.step % t.snapshot_freq_for_preemption == 0 or last:
    save_training(tr)
  if tr.step % t.snapshot_freq == 0 or tr.step == t.n_iters:
    save_training(tr, tr.step // t.snapshot_freq)
  return time.perf_counter() - t0


def _snapshot_due(tr: Training) -> bool:
  t = tr.config.training
  return (tr.step % t.snapshot_freq_for_preemption == 0
          or tr.step == t.n_iters)


def _log_losses(log, step: int, means, tail: str, stds=None):
  """A step's loss lines as the JAX loop writes them (`run_lib.py:
  260-276`): the means (and `stds`) of the joint step's four terms, with
  `tail` after the means, or the score-only step's loss alone in one
  line."""
  if len(means) == 1:
    std = "" if stds is None else f", std: {stds[0]:.5e}"
    log(f"step: {step}, training loss mean: {means[0]:.5e}{std} ({tail})")
    return
  for what, vals, end in (("mean", means, f" ({tail})"), ("std", stds, "")):
    if vals is not None:
      log(f"step: {step}, loss {what}: {vals[0]:.5e}, score: "
          f"{vals[1]:.5e}, flow: {vals[2]:.5e}, logp: {vals[3]:.5e}{end}")


def train_steps(tr: Training, steps: int, log=print) -> List[dict]:
  """Run `steps` steps from step `tr.step`; per step the means of the
  four losses (the loss alone without a flow) and the seconds from the
  batch's upload to the losses on the host. With a work directory, after
  a step that brings the count to s, the meta pair is written when s is a
  multiple of
  `training.snapshot_freq_for_preemption` or the call's last step, and the
  numbered pair `s // training.snapshot_freq` when s is a multiple of
  `training.snapshot_freq` or `training.n_iters` (`run_lib.py:276-300`);
  the row's `save_seconds` is their host time, outside `seconds`. Then,
  under `training.snapshot_sampling`, when s is a multiple of
  `training.snapshot_freq_for_preemption` or `training.n_iters`,
  `snapshot_sampling` (`run_lib.py:316-318`); the row's "snapshot" is its
  report."""
  out = []
  for i in range(steps):
    row = _step(tr)
    _log_losses(log, row["step"], [row[k] for k in joint_lib.METRICS
                                   if k in row], f"{row['seconds']:.3f} s")
    if tr.workdir is not None:
      row["save_seconds"] = _save(tr, i == steps - 1)
      if tr.config.training.snapshot_sampling and _snapshot_due(tr):
        row["snapshot"] = snapshot_sampling(tr, log)
    out.append(row)
  return out


def train(config, workdir: str, device="cuda", log: Callable = logging.info,
          on_step: Optional[Callable[[dict], None]] = None) -> Training:
  """The training loop (`indm_tpu/run_lib.py:195-320`): both nets built
  and restored from `workdir` (`build_training`), then the steps of
  indices from the restored step to `training.n_iters`, inclusive, as the
  JAX loop runs them. Every `training.log_freq` steps two lines, the means
  of the loss and its score, flow and prior terms with the steps a second
  since the last such line, and their standard deviations (the
  reference's regression signal); without a flow (the score-only step)
  one line, the loss's mean and standard deviation and the steps a
  second. After each step the checkpoints as
  `train_steps` writes them (the meta pair also after the last step); at a
  count that is a multiple of `training.snapshot_freq_for_preemption`,
  with `eval.enable_bpd`, the bits/dim sections on the test split with the
  score net's EMA (`in_training_bpd`), and there or at
  `training.n_iters`, with `training.snapshot_sampling`,
  `snapshot_sampling`. `on_step(row)` sees each step's row (as
  `train_steps` makes it, with "bpd" and "snapshot" where they ran).

  The dequantisation noise starts from `default_rng(config.seed)`, the JAX
  loop's `default_rng(seed + initial_step)` at step 0; a restored run
  goes on with the saved generator (the JAX loop reseeds it with the
  step), so that a run that stops and resumes takes the steps of one that
  does not. Returns the Training."""
  tr = build_training(config, device=device, workdir=workdir)
  t = config.training
  os.makedirs(os.path.join(workdir, "samples"), exist_ok=True)
  log(f"Starting training loop at step {tr.step}.")
  eval_ds = data_lib.eval_dataset(config) if config.eval.enable_bpd else None
  t0 = time.time()
  for step in range(tr.step, t.n_iters + 1):
    row = _step(tr)
    if step % t.log_freq == 0:
      per = [m.numpy() for m in row["per_example"]]
      rate = t.log_freq / max(time.time() - t0, 1e-9)
      _log_losses(log, step, [p.mean() for p in per],
                  f"{rate:.2f} steps/s", [p.std() for p in per])
      t0 = time.time()
    row["save_seconds"] = _save(tr, step == t.n_iters)
    if tr.step % t.snapshot_freq_for_preemption == 0 and eval_ds is not None:
      row["bpd"] = in_training_bpd(tr, eval_ds, log)
    if t.snapshot_sampling and _snapshot_due(tr):
      row["snapshot"] = snapshot_sampling(tr, log)
    if on_step is not None:
      on_step(row)
  return tr


def eval_copies(tr: Training):
  """(score net on its EMA, flow as it stands or None), both copies in
  eval mode without gradients, as the JAX loop evaluates inside
  training."""
  score_model = copy.deepcopy(tr.score_model).eval().requires_grad_(False)
  tr.score_ema.copy_to(score_model)
  if tr.flow_model is None:
    return score_model, None
  flow_model = copy.deepcopy(tr.flow_model).eval().requires_grad_(False)
  return score_model, flow_model


def bpd(config, sde, score_model, flow_model, eval_ds, step: int,
        eval: bool, device, log=print) -> dict:
  """`evaluation.get_bpd` of the eval-mode nets on `eval_ds`."""
  inverse_scaler = data_lib.get_data_inverse_scaler(config)
  score_fn = get_score_fn(config, sde, score_model,
                          continuous=config.training.continuous,
                          differentiable=True)

  def ff(x):
    return flow_forward(config, flow_model, x, train=False)

  return evaluation.get_bpd(
      config, eval_ds, data_lib.get_data_scaler(config),
      likelihood_lib.get_elbo_fn(config, sde, inverse_scaler),
      likelihood_lib.get_likelihood_fn(config, sde, inverse_scaler,
                                       rtol=config.eval.rtol,
                                       atol=config.eval.atol),
      score_fn, None if flow_model is None else ff, step=step, eval=eval,
      device=device, log=log)


def in_training_bpd(tr: Training, eval_ds, log=print) -> dict:
  """Bits/dim inside the training loop (`indm_tpu/run_lib.py:
  _in_training_bpd`): `get_bpd` at eval=False (10000 test images, capped
  by the split, a tenth of them for the NLL sections) with the score
  net's EMA and the flow's parameters."""
  score_model, flow_model = eval_copies(tr)
  return bpd(tr.config, tr.sde, score_model, flow_model, eval_ds, tr.step,
             False, tr.device, log)


def snapshot_sampling(tr: Training, log=print) -> dict:
  """In-training sampling (`run_lib.py:378-406`): the score net on its EMA
  and the flow as it stands, both copied into eval mode, sample
  `eval.num_samples` images in rounds of `sampling.batch_size` into
  `<workdir>/samples/iter_{step}/`, round r drawn from a generator seeded
  step + 1 + r; then `evaluation.compute_fid_and_is` over them. Returns
  the report."""
  config = tr.config
  score_model, flow_model = eval_copies(tr)
  shape = (config.sampling.batch_size, config.data.num_channels,
           config.data.image_size, config.data.image_size)
  s = Sampling(tr.sde, score_model, flow_model, sampling_lib.get_sampling_fn(
      config, tr.sde, shape, data_lib.get_data_inverse_scaler(config),
      config.sampling.truncation_time, device=tr.device), tr.step)
  this_dir = os.path.join(tr.workdir, "samples", f"iter_{tr.step}")
  rounds = (config.eval.num_samples - 1) // config.sampling.batch_size + 1
  log("sampling start ...")
  sample_rounds(config, s, this_dir, config.sampling.batch_size, rounds, log,
                first_seed=tr.step + 1)
  del s, score_model, flow_model
  log("sampling end ... computing FID ...")
  return evaluation.compute_fid_and_is(config, this_dir, None,
                                       config.eval.num_samples,
                                       device=tr.device, log=log)


def sample_rounds(config, s: Sampling, sample_dir: str, batch: int,
                  rounds: int, log=print, first_seed: Optional[int] = None,
                  data_mean: Optional[torch.Tensor] = None) -> List[dict]:
  """`rounds` rounds of `batch` images (the prior centred at `data_mean`
  where it is given) through the cache of `sampling_io.get_samples`
  (`run_lib.py:378-473`), round r drawn from a generator seeded
  `first_seed + r` (default `config.seed + 1000`, `run_lib.py:460-463`).
  Round r's files are named by r (`samples_{r}.npz` and the rest, under
  `sample_dir`): a round already on disk is skipped, one with its
  before-flow file only gets the flow inverse again, and the denoise
  search and the extra steps resume round r's cached trajectory. (Under
  `sampling.idx_rand` the JAX package names a round by an unseeded random
  index, `run_lib.py:464`, so that it never finds a cached round or
  trajectory to resume.) One dict per round: "round", "cached" (None,
  "after" or "before"), "resumed" (the resumed file or None), nfe,
  seconds, images_per_s, the NHWC images before and after the flow (CPU
  float tensors; a cached round's "after" is its uint8 file over 255 and
  its "before", nfe and images_per_s None) and the written paths."""
  device = next(s.score_model.parameters()).device
  if first_seed is None:
    first_seed = config.seed + 1000
  _, flow_inverse = make_eval_fns(config, s.sde, s.score_model, s.flow_model)
  out = []
  for r in range(rounds):
    gen = torch.Generator(device=device).manual_seed(first_seed + r)
    if device.type == "cuda":
      torch.cuda.synchronize(device)
    t0 = time.perf_counter()

    def one_round(before_data=None, final_time=0.0):
      return sample_round(config, s, generator=gen, data_mean=data_mean,
                          before_data=before_data, final_time=final_time)

    got = sampling_io.get_samples(config, flow_inverse, one_round, r,
                                  sample_dir, config.sampling.temperature,
                                  device=device, log=log)
    if device.type == "cuda":
      torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    row = {"round": r, "cached": got["cached"], "resumed": got["resumed"],
           "nfe": None, "seconds": seconds, "images_per_s": None,
           "before": None,
           "after": torch.from_numpy(got["after"]).float() / 255.0,
           "paths": got["paths"]}
    if got["sampled"] is None:
      log(f"round {r}: cached ({got['cached']} the flow), not sampled "
          f"again; seconds={seconds:.3f}")
    else:
      before, after, _, nfe = got["sampled"]
      row.update(nfe=nfe, images_per_s=batch / seconds,
                 before=before.float().cpu(), after=after.float().cpu())
      log(f"round {r}: nfe={nfe} seconds={seconds:.3f} "
          f"images/s={batch / seconds:.3f}")
    out.append(row)
  return out


def compute_latent_data_mean(config, sde, batches, scaler, ff,
                             device) -> torch.Tensor:
  """The latent mean over the training split that centres the VE prior
  (`indm_tpu/run_lib.py:_compute_latent_data_mean`): (num_train_data - 1)
  // training.batch_size + 1 batches of `batches` (the JAX package draws
  them from the training iterator at `eval.batch_size`), each dequantised
  with one `default_rng(0)`, scaled and sent through `ff`, the latent taken
  to T by `marginal_prob` except under VESDE; their sum over the batch
  axis in float32 on the host, over `training.num_train_data`. Returns
  [C,H,W] on `device`."""
  np_rng = np.random.default_rng(0)
  n_batches = ((config.training.num_train_data - 1)
               // config.training.batch_size + 1)
  total = 0.0
  for _ in range(n_batches):
    b = next(batches)
    b = scaler((255.0 * b + np_rng.random(b.shape, dtype=np.float32))
               / 256.0)
    x = torch.from_numpy(np.ascontiguousarray(b.transpose(0, 3, 1, 2)))
    with torch.no_grad():
      z, _ = ff(x.to(device))
      if config.training.sde != "vesde":
        z, _ = sde.marginal_prob(z, torch.ones(z.shape[0], device=z.device))
    total = total + z.float().cpu().numpy().sum(0)
  mean = np.asarray(total / config.training.num_train_data, np.float32)
  return torch.from_numpy(mean).to(device)


def evaluate(config, workdir: str, device="cuda", log=print) -> dict:
  """Evaluate the checkpoint in `workdir` (`run_lib.py:417-494`): restore
  both streams (`build_sampling`), then with `eval.enable_bpd` the
  bits/dim sections of `evaluation.get_bpd` on the test split
  (`data.load_arrays`) at the checkpoint's step, and with
  `eval.enable_sampling` the `eval.num_samples` images in rounds of
  `sampling.batch_size` under `<workdir>/eval` (named by round, where the
  JAX package may draw a random index), with `eval.data_mean` the prior
  centred at `compute_latent_data_mean` of the training split, then
  `evaluation.compute_fid_and_is` over that directory
  (`run_lib.py:468-469`). Returns {"bpd": get_bpd's dict or None,
  "rounds": the rounds' stats without images, "fid": the FID report or
  None, "step": the checkpoint's step, "data_mean": the mean or None}."""
  eval_dir = os.path.join(workdir, "eval")
  os.makedirs(eval_dir, exist_ok=True)
  s = build_sampling(config, config.sampling.batch_size, device=device,
                     workdir=workdir)
  for m in (s.score_model, s.flow_model):
    if m is not None:
      m.requires_grad_(False)
  device = next(s.score_model.parameters()).device
  train_split, test_split = data_lib.load_arrays(config)
  out = {"bpd": None, "rounds": [], "fid": None, "step": s.step,
         "data_mean": None}
  if config.eval.enable_bpd:
    out["bpd"] = bpd(config, s.sde, s.score_model, s.flow_model,
                     data_lib.EvalBatches(test_split, config.eval.batch_size),
                     s.step, True, device, log)
  if config.eval.enable_sampling:
    data_mean = None
    if config.eval.data_mean:
      batches = data_lib.TrainBatches(train_split, config.eval.batch_size,
                                      config.data.random_flip, config.seed)
      data_mean = compute_latent_data_mean(
          config, s.sde, batches, data_lib.get_data_scaler(config),
          lambda x: flow_forward(config, s.flow_model, x, train=False,
                                 eval_logdet=False), device)
      out["data_mean"] = data_mean
      log(f"latent data mean over {config.training.num_train_data} "
          f"training images: mean {data_mean.mean().item():.5e}, std "
          f"{data_mean.std().item():.5e}")
    rounds = (config.eval.num_samples - 1) // config.sampling.batch_size + 1
    log("sampling start ...")
    out["rounds"] = [
        {k: v for k, v in r.items() if k not in ("before", "after")}
        for r in sample_rounds(config, s, eval_dir,
                               config.sampling.batch_size, rounds, log,
                               data_mean=data_mean)]
    log("sampling end ... computing FID ...")
    del s
    out["fid"] = evaluation.compute_fid_and_is(
        config, eval_dir, None, config.eval.num_samples, device=device,
        log=log)
  return out
