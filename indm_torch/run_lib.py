"""Sampling orchestration (counterpart of `indm_tpu/run_lib.py:168-189,
347-375`): the eval-mode score function and flow inverse, and one sampling
round.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from indm_torch import data as data_lib
from indm_torch import sampling as sampling_lib
from indm_torch import sde as sde_lib
from indm_torch.flows.flow_model import create_flow_model, flow_forward
from indm_torch.models.registry import create_model, get_score_fn


def set_f32_numerics():
  """Full f32 convolutions and matmuls on the card, as the JAX package
  computes in f32: cuDNN's TF32 default is turned off."""
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False


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
                 prior_eps: Optional[torch.Tensor] = None):
  """One round: (before [B,H,W,C], after [B,H,W,C], nfe). The prior sample
  and the flow prior's epsilon are drawn from `generator` unless given."""
  score_fn, flow_inverse = make_eval_fns(config, s.sde, s.score_model,
                                         s.flow_model, generator, prior_eps)
  return s.sampling_fn(score_fn, flow_inverse,
                       temperature=config.sampling.temperature,
                       generator=generator, prior_noise=prior_noise)
