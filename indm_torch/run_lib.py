"""Training and sampling orchestration (counterpart of
`indm_tpu/run_lib.py:168-277, 347-375`): the joint training step on
seeded synthetic data, the eval-mode score function and flow inverse, and
one sampling round (ODE or PC, as the config says). Checkpoints, snapshot sampling and evaluation inside
the training loop are not ported yet.
"""

from __future__ import annotations

import time
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from indm_torch import data as data_lib
from indm_torch import ema as ema_lib
from indm_torch import joint as joint_lib
from indm_torch import optim as optim_lib
from indm_torch import sampling as sampling_lib
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


def build_sampling(config, batch: int, device="cuda", seed: Optional[int] = None
                   ) -> Sampling:
  """Models with weights drawn from `seed` (default `config.seed`; the score
  net from seed, the flow from seed + 1) and the configured sampler for
  `batch` images, all on `device`."""
  if torch.device(device).type == "cuda":
    set_f32_numerics()
  seed = config.seed if seed is None else seed
  sde = sde_lib.get_sde(config)
  score_model = create_model(config, seed=seed, device=device)
  flow_model = create_flow_model(config, seed=seed + 1, device=device)
  shape = (batch, config.data.num_channels, config.data.image_size,
           config.data.image_size)
  sampling_fn = sampling_lib.get_sampling_fn(
      config, sde, shape, data_lib.get_data_inverse_scaler(config),
      config.sampling.truncation_time, device=device)
  return Sampling(sde, score_model, flow_model, sampling_fn)


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


class Training(NamedTuple):
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


def build_training(config, device="cuda", seed: Optional[int] = None
                   ) -> Training:
  """Both nets in train mode with weights drawn from `seed` (default
  `config.seed`; the score net from seed, the flow from seed + 1), their
  optimizers and EMAs, the joint step, and the seeded synthetic batches,
  all on `device`."""
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
  batches = data_lib.TrainBatches(data_lib.synthetic(config),
                                  config.training.batch_size,
                                  config.data.random_flip, config.seed)
  generator = torch.Generator(device=device).manual_seed(seed + 2)
  return Training(config, device, sde, score_model, flow_model, score_opt,
                  flow_opt, score_ema, flow_ema, step_fn, batches,
                  np.random.default_rng(config.seed),
                  np.random.default_rng(seed + 3), generator)


def next_batch(tr: Training) -> torch.Tensor:
  """The next batch, uniformly dequantised ((255 x + u) / 256) and scaled,
  as an NCHW float32 tensor on the training device."""
  batch = next(tr.batches)
  batch = (255.0 * batch + tr.np_rng.random(batch.shape,
                                            dtype=np.float32)) / 256.0
  batch = data_lib.get_data_scaler(tr.config)(batch)
  return torch.from_numpy(np.ascontiguousarray(
      batch.transpose(0, 3, 1, 2))).to(tr.device)


def train_steps(tr: Training, steps: int, log=print,
                first_step: int = 0) -> List[dict]:
  """Run `steps` joint steps; per step the means of the four losses and
  the seconds from the batch's upload to the losses on the host. Steps are
  numbered from `first_step` in the log."""
  out = []
  for i in range(first_step, first_step + steps):
    if tr.device.type == "cuda":
      torch.cuda.synchronize(tr.device)
    t0 = time.perf_counter()
    metrics = tr.step_fn(next_batch(tr), generator=tr.generator,
                         host_rng=tr.host_rng)
    means = [m.mean().item() for m in metrics]
    seconds = time.perf_counter() - t0
    row = dict(zip(joint_lib.METRICS, means), step=i, seconds=seconds,
               per_example=[m.cpu() for m in metrics])
    log(f"step: {i}, loss mean: {means[0]:.5e}, score: {means[1]:.5e}, "
        f"flow: {means[2]:.5e}, logp: {means[3]:.5e} ({seconds:.3f} s)")
    out.append(row)
  return out
