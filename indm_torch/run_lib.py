"""Training, evaluation and sampling orchestration (counterpart of
`indm_tpu/run_lib.py:53-142, 168-300, 347-471`): the models restored from
a work directory's checkpoints (`load_model`, `load_flow_model`), the
joint training step on seeded synthetic data with the checkpoints written
as the JAX loop writes them, the eval-mode score function and flow, one
sampling round (ODE or PC, as the config says), snapshot sampling with
FID inside the training loop, and `evaluate`: bits/dim of the checkpoint,
then sampling rounds and their FID, IS and KID. Bits/dim inside the
training loop is not ported yet.
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
                 prior_eps: Optional[torch.Tensor] = None, step_noise=None):
  """One round: (before [B,H,W,C], after [B,H,W,C], the PC sampler's
  step-(N-2) mean [B,H,W,C] or None, nfe). The prior sample, the PC
  sampler's step noise (`step_noise(i)`, see `sampling.get_pc_sampler`)
  and the flow prior's epsilon are drawn from `generator` unless given."""
  score_fn, flow_inverse = make_eval_fns(config, s.sde, s.score_model,
                                         s.flow_model, generator, prior_eps)
  kw = {} if step_noise is None else {"step_noise": step_noise}
  return s.sampling_fn(score_fn, flow_inverse,
                       temperature=config.sampling.temperature,
                       generator=generator, prior_noise=prior_noise, **kw)


@dataclasses.dataclass
class Training:
  config: object
  device: torch.device
  sde: sde_lib.SDE
  score_model: torch.nn.Module
  flow_model: torch.nn.Module
  score_opt: optim_lib.AdamW
  flow_opt: optim_lib.AdamW
  score_ema: ema_lib.EMA
  flow_ema: ema_lib.EMA
  step_fn: Callable
  batches: data_lib.TrainBatches
  np_rng: np.random.Generator       # dequantisation noise
  host_rng: np.random.Generator     # the flow estimator's n
  generator: torch.Generator        # every draw on the device
  workdir: Optional[str] = None     # where checkpoints are read and written
  step: int = 0                     # steps taken, the checkpoints' step
  restore_seconds: float = 0.0      # host seconds of the restore


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
  """Write both streams: the meta pair, or with `numbered` = k
  `checkpoints/checkpoint_{k}.pth` and `flow_checkpoint_{k}.pth`."""
  if numbered is None:
    d, name = os.path.join(tr.workdir, "checkpoints-meta"), ""
  else:
    d, name = os.path.join(tr.workdir, "checkpoints"), f"_{numbered}"
  ckpt_lib.save_checkpoint(
      os.path.join(d, f"checkpoint{name}.pth"),
      ckpt_lib.stream_state(tr.score_model, tr.score_opt, tr.score_ema,
                            tr.step, rng=rng_state(tr)))
  ckpt_lib.save_checkpoint(
      os.path.join(d, f"flow_checkpoint{name}.pth"),
      ckpt_lib.stream_state(tr.flow_model, tr.flow_opt, tr.flow_ema,
                            tr.step))


def build_training(config, device="cuda", seed: Optional[int] = None,
                   workdir: Optional[str] = None) -> Training:
  """Both nets in train mode with weights drawn from `seed` (default
  `config.seed`; the score net from seed, the flow from seed + 1), their
  optimizers and EMAs, the joint step, and the seeded synthetic batches,
  all on `device`. With `workdir` the state is then restored from its
  checkpoints (`load_model`, `load_flow_model`; the generators and the
  batches' place from the score stream), and `train_steps` writes them
  there."""
  device = check_device(device)
  if device.type == "cuda":
    set_f32_numerics()
  seed = config.seed if seed is None else seed
  sde = sde_lib.get_sde(config)
  score_model = create_model(config, seed=seed, device=device).train()
  flow_model = create_flow_model(config, seed=seed + 1, device=device)
  if flow_model is None:
    raise NotImplementedError("score-only training is not ported yet")
  flow_model.train()
  score_opt = optim_lib.make_optimizer(config, score_model.parameters())
  flow_opt = optim_lib.make_optimizer(config, flow_model.parameters(),
                                      lr=config.flow.lr)
  score_ema = ema_lib.EMA(score_opt.params, config.model.ema_rate)
  flow_ema = ema_lib.EMA(flow_opt.params, config.flow.ema_rate)
  step_fn = joint_lib.make_joint_step_fn(config, sde, score_model,
                                         flow_model, score_opt, flow_opt,
                                         score_ema, flow_ema)
  batches = data_lib.TrainBatches(data_lib.synthetic(config)[0],
                                  config.training.batch_size,
                                  config.data.random_flip, config.seed)
  generator = torch.Generator(device=device).manual_seed(seed + 2)
  tr = Training(config, device, sde, score_model, flow_model, score_opt,
                flow_opt, score_ema, flow_ema, step_fn, batches,
                np.random.default_rng(config.seed),
                np.random.default_rng(seed + 3), generator, workdir)
  if workdir is not None:
    t0 = time.perf_counter()
    state = load_model(config, workdir, score_model, score_opt, score_ema)
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


def train_steps(tr: Training, steps: int, log=print) -> List[dict]:
  """Run `steps` joint steps from step `tr.step`; per step the means of
  the four losses and the seconds from the batch's upload to the losses on
  the host. With a work directory, after a step that brings the count to
  s, the meta pair is written when s is a multiple of
  `training.snapshot_freq_for_preemption` or the call's last step, and the
  numbered pair `s // training.snapshot_freq` when s is a multiple of
  `training.snapshot_freq` or `training.n_iters` (`run_lib.py:276-300`);
  the row's `save_seconds` is their host time, outside `seconds`. Then,
  under `training.snapshot_sampling`, when s is a multiple of
  `training.snapshot_freq_for_preemption` or `training.n_iters`,
  `snapshot_sampling` (`run_lib.py:316-318`); the row's "snapshot" is its
  report."""
  t = tr.config.training
  out = []
  for i in range(steps):
    if tr.device.type == "cuda":
      torch.cuda.synchronize(tr.device)
    t0 = time.perf_counter()
    metrics = tr.step_fn(next_batch(tr), generator=tr.generator,
                         host_rng=tr.host_rng)
    means = [m.mean().item() for m in metrics]
    seconds = time.perf_counter() - t0
    row = dict(zip(joint_lib.METRICS, means), step=tr.step, seconds=seconds,
               per_example=[m.cpu() for m in metrics])
    log(f"step: {tr.step}, loss mean: {means[0]:.5e}, score: "
        f"{means[1]:.5e}, flow: {means[2]:.5e}, logp: {means[3]:.5e} "
        f"({seconds:.3f} s)")
    tr.step += 1
    if tr.workdir is not None:
      t0 = time.perf_counter()
      if tr.step % t.snapshot_freq_for_preemption == 0 or i == steps - 1:
        save_training(tr)
      if tr.step % t.snapshot_freq == 0 or tr.step == t.n_iters:
        save_training(tr, tr.step // t.snapshot_freq)
      row["save_seconds"] = time.perf_counter() - t0
      if t.snapshot_sampling and (
          tr.step % t.snapshot_freq_for_preemption == 0
          or tr.step == t.n_iters):
        row["snapshot"] = snapshot_sampling(tr, log)
    out.append(row)
  return out


def snapshot_sampling(tr: Training, log=print) -> dict:
  """In-training sampling (`run_lib.py:378-406`): the score net on its EMA
  and the flow as it stands, both copied into eval mode, sample
  `eval.num_samples` images in rounds of `sampling.batch_size` into
  `<workdir>/samples/iter_{step}/`, round r drawn from a generator seeded
  step + 1 + r; then `evaluation.compute_fid_and_is` over them. Returns
  the report."""
  config = tr.config
  score_model = copy.deepcopy(tr.score_model).eval().requires_grad_(False)
  tr.score_ema.copy_to(score_model)
  flow_model = copy.deepcopy(tr.flow_model).eval().requires_grad_(False)
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
                  rounds: int, log=print,
                  first_seed: Optional[int] = None) -> List[dict]:
  """`rounds` rounds of `batch` images, round r drawn from a generator
  seeded `first_seed + r` (default `config.seed + 1000`,
  `run_lib.py:460-463`) and written as
  `samples_{r}.npz` (and the images before the flow) under `sample_dir`;
  one dict per round with nfe, seconds, images_per_s, the NHWC images
  before and after the flow (CPU float tensors) and the written paths."""
  device = next(s.score_model.parameters()).device
  if first_seed is None:
    first_seed = config.seed + 1000
  out = []
  for r in range(rounds):
    gen = torch.Generator(device=device).manual_seed(first_seed + r)
    if device.type == "cuda":
      torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    before, after, search, nfe = sample_round(config, s, generator=gen)
    if device.type == "cuda":
      torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    before, after = before.float().cpu(), after.float().cpu()
    paths = sampling_io.write_round(
        sample_dir, r, before.numpy(), after.numpy(),
        None if search is None else search.float().cpu().numpy())
    log(f"round {r}: nfe={nfe} seconds={seconds:.3f} "
        f"images/s={batch / seconds:.3f}")
    out.append({"round": r, "nfe": nfe, "seconds": seconds,
                "images_per_s": batch / seconds, "before": before,
                "after": after, "paths": paths})
  return out


def evaluate(config, workdir: str, device="cuda", log=print) -> dict:
  """Evaluate the checkpoint in `workdir` (`run_lib.py:417-471`): restore
  both streams (`build_sampling`), then with `eval.enable_bpd` the
  bits/dim sections of `evaluation.get_bpd` on the test split at the
  checkpoint's step, and with `eval.enable_sampling` the
  `eval.num_samples` images in rounds of `sampling.batch_size` under
  `<workdir>/eval` (named by round, where the JAX package may
  draw a random index), then `evaluation.compute_fid_and_is` over that
  directory (`run_lib.py:468-469`). Returns {"bpd": get_bpd's dict or
  None, "rounds": the rounds' stats without images, "fid": the FID report
  or None, "step": the checkpoint's step}."""
  if config.eval.enable_sampling and config.eval.data_mean:
    raise NotImplementedError(
        "eval.data_mean (the latent data mean of the VE prior) is not "
        "ported: it comes with VE training")
  eval_dir = os.path.join(workdir, "eval")
  os.makedirs(eval_dir, exist_ok=True)
  s = build_sampling(config, config.sampling.batch_size, device=device,
                     workdir=workdir)
  for m in (s.score_model, s.flow_model):
    if m is not None:
      m.requires_grad_(False)
  out = {"bpd": None, "rounds": [], "fid": None, "step": s.step}
  if config.eval.enable_bpd:
    inverse_scaler = data_lib.get_data_inverse_scaler(config)
    score_fn = get_score_fn(config, s.sde, s.score_model,
                            continuous=config.training.continuous,
                            differentiable=True)

    def ff(x):
      return flow_forward(config, s.flow_model, x, train=False)

    out["bpd"] = evaluation.get_bpd(
        config, data_lib.eval_dataset(config),
        data_lib.get_data_scaler(config),
        likelihood_lib.get_elbo_fn(config, s.sde, inverse_scaler),
        likelihood_lib.get_likelihood_fn(config, s.sde, inverse_scaler,
                                         rtol=config.eval.rtol,
                                         atol=config.eval.atol),
        score_fn, None if s.flow_model is None else ff, step=s.step,
        eval=True, device=next(s.score_model.parameters()).device, log=log)
  if config.eval.enable_sampling:
    rounds = (config.eval.num_samples - 1) // config.sampling.batch_size + 1
    log("sampling start ...")
    out["rounds"] = [
        {k: v for k, v in r.items() if k not in ("before", "after")}
        for r in sample_rounds(config, s, eval_dir,
                               config.sampling.batch_size, rounds, log)]
    log("sampling end ... computing FID ...")
    del s
    out["fid"] = evaluation.compute_fid_and_is(
        config, eval_dir, None, config.eval.num_samples, device=device,
        log=log)
  return out
