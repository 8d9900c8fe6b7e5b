"""The probability-flow ODE sampler and the predictor-corrector samplers
(PyTorch).

Counterpart of `indm_tpu/sampling.py:36-416`. The ODE sampler integrates
the probability-flow ODE from T to eps with RK45 and takes the
reverse-diffusion predictor's mean as the denoise step. The PC sampler
takes a predictor and a corrector from the registries (the JAX names:
`euler_maruyama`, `reverse_diffusion`, `ancestral_sampling`, `none`;
`langevin`, `ald`, `none`) on any of the four SDEs, in the variant the
config asks for: the plain loop over `sampling.num_scales` times (with
`sampling.snr_scheduling` 'none' or 'linear'), the denoise search
(`sampling.pc_denoise`) or the extra steps (`sampling.more_step`). Both
pull the sample back through the flow inverse and apply the inverse
scaler. Samplers take callables:

  score_fn(x, t) -> score        (eval mode, over NCHW x)
  flow_inverse(x) -> x'          (or None for flow.model='identity')

and return (before the flow, after the flow, the plain PC loop's
step-(N-2) mean or None, the number of score evaluations), images NHWC, as
the JAX samplers do. Every random draw comes from an explicit
`torch.Generator` or is handed in, so that a test can replay the JAX
package's draws.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from indm_torch import ode as ode_lib
from indm_torch import sde as sde_lib
from indm_torch.sde import right_bcast

PREDICTORS = {}
CORRECTORS = {}


def _register(table, kind, name):
  def reg(fn):
    if name in table:
      raise ValueError(f"Already registered {kind}: {name}")
    table[name] = fn
    return fn
  return reg


def get_predictor(name):
  return _lookup(PREDICTORS, "predictor", name)


def get_corrector(name):
  return _lookup(CORRECTORS, "corrector", name)


def _lookup(table, kind, name):
  if name.lower() not in table:
    raise ValueError(f"unknown {kind} {name!r}; the registry holds "
                     f"{sorted(table)}")
  return table[name.lower()]


def _normal(x, generator):
  return torch.randn(x.shape, generator=generator, device=x.device,
                     dtype=x.dtype)


def _index(sde, t):
  """The discrete tables' index of t: t (N - 1) / T truncated, in
  float32 as the JAX package computes it."""
  return (t * (sde.N - 1) / sde.T).long()


# Predictors: update_fn(x, t, next_t=None, noise=None, generator=None) ->
# (x, x_mean); the noise is drawn like x from `generator` when not given.


@_register(PREDICTORS, "predictor", "euler_maruyama")
def euler_maruyama_predictor(sde, score_fn, probability_flow=False):
  """One Euler-Maruyama step of the reverse SDE with dt = -1 / sde.N,
  whatever `sampling.num_scales` is, as the JAX predictor takes it."""
  rsde = sde.reverse(score_fn, probability_flow)

  def update_fn(x, t, next_t=None, noise=None, generator=None):
    dt = -1.0 / rsde.N
    z = _normal(x, generator) if noise is None else noise
    drift, diffusion = rsde.sde(x, t)
    x_mean = x + drift * dt
    return x_mean + right_bcast(diffusion, x) * math.sqrt(-dt) * z, x_mean

  return update_fn


@_register(PREDICTORS, "predictor", "reverse_diffusion")
def reverse_diffusion_predictor(sde, score_fn, probability_flow=False):
  rsde = sde.reverse(score_fn, probability_flow)

  def update_fn(x, t, next_t=None, noise=None, generator=None):
    f, G = rsde.discretize(x, t, next_t)
    x_mean = x - f
    z = _normal(x, generator) if noise is None else noise
    return x_mean + right_bcast(G, x) * z, x_mean

  return update_fn


@_register(PREDICTORS, "predictor", "ancestral_sampling")
def ancestral_sampling_predictor(sde, score_fn, probability_flow=False):
  """The ancestral step of the SMLD table (VE) or the DDPM table (VP, and
  GeometricVP by subclass). The JAX package refuses it under the
  probability flow and on subVP; so does this."""
  if probability_flow:
    raise NotImplementedError("the ancestral_sampling predictor does not "
                              "take sampling.probability_flow (the JAX "
                              "package asserts it off)")
  if isinstance(sde, sde_lib.VESDE):
    def update_fn(x, t, next_t=None, noise=None, generator=None):
      timestep = _index(sde, t)
      sigmas = sde.discrete_sigmas.to(x.device)
      sigma = sigmas[timestep]
      adjacent = torch.where(timestep == 0, torch.zeros_like(t),
                             sigmas[torch.clamp(timestep - 1, min=0)])
      score = score_fn(x, t)
      x_mean = x + score * right_bcast(sigma ** 2 - adjacent ** 2, x)
      std = torch.sqrt(torch.clamp(
          (adjacent ** 2 * (sigma ** 2 - adjacent ** 2)) / (sigma ** 2),
          min=0.0))
      z = _normal(x, generator) if noise is None else noise
      return x_mean + right_bcast(std, x) * z, x_mean
  elif isinstance(sde, sde_lib.VPSDE):
    def update_fn(x, t, next_t=None, noise=None, generator=None):
      beta = sde.discrete_betas.to(x.device)[_index(sde, t)]
      score = score_fn(x, t)
      x_mean = ((x + right_bcast(beta, x) * score)
                / right_bcast(torch.sqrt(1.0 - beta), x))
      z = _normal(x, generator) if noise is None else noise
      return x_mean + right_bcast(torch.sqrt(beta), x) * z, x_mean
  else:
    raise NotImplementedError(
        f"SDE class {type(sde).__name__} not yet supported by the "
        "ancestral_sampling predictor (nor by the JAX package's).")
  return update_fn


@_register(PREDICTORS, "predictor", "none")
def none_predictor(sde, score_fn, probability_flow=False):
  def update_fn(x, t, next_t=None, noise=None, generator=None):
    return x, x
  return update_fn


# Correctors: update_fn(x, t, snr_t=None, noise=None, generator=None) ->
# (x, x_mean); `noise` is a list of the n_steps draws, drawn from
# `generator` when not given; `snr_t` replaces the corrector's snr.


def _corrector_alpha(sde, name):
  """alpha(t) of the corrector's step: the DDPM alphas at t's index under
  VP and GeometricVP, 1 under VE. subVP has no alphas: the JAX package's
  `_corrector_alpha` fails on it, and this refuses it."""
  if isinstance(sde, sde_lib.subVPSDE):
    raise NotImplementedError(
        f"the {name} corrector reads the DDPM alphas, which subVPSDE lacks "
        "(the JAX package's _corrector_alpha fails on subvpsde too)")
  if isinstance(sde, sde_lib.VPSDE):
    return lambda t: sde.alphas.to(t.device)[_index(sde, t)]
  return torch.ones_like


def _per_sample_norm_mean(v):
  return torch.linalg.vector_norm(v.reshape(v.shape[0], -1), dim=-1).mean()


@_register(CORRECTORS, "corrector", "langevin")
def langevin_corrector(sde, score_fn, snr, n_steps):
  """`n_steps` Langevin steps whose size makes the noise's norm snr times
  the score's (batch means of the per-sample norms), times alpha."""
  alpha_of = _corrector_alpha(sde, "langevin")

  def update_fn(x, t, snr_t=None, noise=None, generator=None):
    target_snr = snr if snr_t is None else snr_t
    alpha = alpha_of(t)
    x_mean = x
    for i in range(n_steps):
      grad = score_fn(x, t)
      z = _normal(x, generator) if noise is None else noise[i]
      step_size = ((target_snr * _per_sample_norm_mean(z)
                    / _per_sample_norm_mean(grad)) ** 2 * 2 * alpha)
      x_mean = x + right_bcast(step_size, x) * grad
      x = x_mean + right_bcast(torch.sqrt(step_size * 2), x) * z
    return x, x_mean

  return update_fn


@_register(CORRECTORS, "corrector", "ald")
def ald_corrector(sde, score_fn, snr, n_steps):
  """Annealed Langevin dynamics: the step (snr std(t))^2 2 alpha."""
  alpha_of = _corrector_alpha(sde, "ald")

  def update_fn(x, t, snr_t=None, noise=None, generator=None):
    target_snr = snr if snr_t is None else snr_t
    alpha = alpha_of(t)
    std = sde.marginal_prob(x, t)[1]
    x_mean = x
    for i in range(n_steps):
      grad = score_fn(x, t)
      z = _normal(x, generator) if noise is None else noise[i]
      step_size = (target_snr * std) ** 2 * 2 * alpha
      x_mean = x + right_bcast(step_size, x) * grad
      x = x_mean + z * right_bcast(torch.sqrt(step_size * 2), x)
    return x, x_mean

  return update_fn


@_register(CORRECTORS, "corrector", "none")
def none_corrector(sde, score_fn, snr, n_steps):
  def update_fn(x, t, snr_t=None, noise=None, generator=None):
    return x, x
  return update_fn


def pc_variant(config) -> str:
  """"search" (`sampling.pc_denoise`), "more_step" or "plain"."""
  return ("search" if config.sampling.pc_denoise
          else "more_step" if config.sampling.more_step else "plain")


def get_pc_sampler(config, sde, shape, predictor, corrector, inverse_scaler,
                   snr, n_steps=1, probability_flow=False, denoise=True,
                   eps=1e-3, device="cuda"):
  """The PC sampler (`indm_tpu/sampling.py:210-350`) for NCHW `shape` in
  the config's variant (`pc_variant`):

  - "plain": from the prior, `sampling.num_scales` steps on linspace(T,
    eps), each the corrector (at `snr`, or with `sampling.snr_scheduling`
    'linear' at begin_snr + (end_snr - begin_snr) i / num_scales in
    float32) then the predictor without next_t; the step-(N-2) mean is
    kept for the denoise search.
  - "search": from the prior, N - 1 steps on the sde.N grid with the
    grid's next time as next_t, or from `before_data`; then, unless
    `sampling.need_sample`, the probability flow's reverse-diffusion mean
    from eps to `final_time`.
  - "more_step": from the prior, N steps on the sde.N grid (next_t the
    next time, the last step's its own), the corrector at its own snr, or
    from `before_data`; then, unless `sampling.need_sample`, 100 steps at
    the float32 times exp(linspace(log 1e-3, log 1e-5, 100)) without
    next_t.

  The sample is the last mean (`denoise`) or the last x. The evaluation
  count is sde.N (n_steps + 1) in every variant, as the JAX sampler
  counts it. The predictor and the corrector are built here, so that a
  combination the JAX package fails on raises before any step."""
  variant = pc_variant(config)
  sched = config.sampling.snr_scheduling
  if sched not in ("none", "linear"):
    raise ValueError(sched)
  predictor(sde, None, probability_flow)
  corrector(sde, None, snr, n_steps)
  num_scales = config.sampling.num_scales
  grid = sde_lib.linspace_f32(sde.T, eps, num_scales if variant == "plain"
                              else sde.N)
  extra = np.exp(sde_lib.linspace_f32(np.log(1e-3), np.log(1e-5), 100))

  def snr_at(i):
    if sched == "none":
      return snr
    f32 = np.float32
    begin, end = config.sampling.begin_snr, config.sampling.end_snr
    return float(f32(begin) + f32(f32(end - begin) * f32(i)) / f32(num_scales))

  def pc_sampler(score_fn, flow_inverse=None, temperature=1.0,
                 generator: Optional[torch.Generator] = None,
                 prior_noise: Optional[torch.Tensor] = None,
                 step_noise=None, data_mean: Optional[torch.Tensor] = None,
                 before_data: Optional[torch.Tensor] = None,
                 final_time: float = 0.0):
    """`prior_noise` replaces the prior's standard-normal draw;
    `step_noise(k)` returns the k-th step's (corrector draws, predictor
    draw), counting the steps the round takes from 0 across its loops, in
    place of draws from `generator`; `data_mean` [C,H,W] centres the prior
    (`eval.data_mean`); `before_data` (NCHW, in the model's scale) is the
    cached state that "search" and "more_step" resume from instead of
    sampling the prior, and `final_time` the denoise search's end."""
    corr = corrector(sde, score_fn, snr, n_steps)
    pred = predictor(sde, score_fn, probability_flow)
    b = shape[0]
    ts = torch.from_numpy(grid).to(device)
    taken = [0]

    def step(x, t, next_t, snr_t):
      c_noise, p_noise = ((None, None) if step_noise is None
                          else step_noise(taken[0]))
      taken[0] += 1
      x, x_mean = corr(x, t.expand(b), snr_t, noise=c_noise,
                       generator=generator)
      return pred(x, t.expand(b), None if next_t is None else
                  next_t.expand(b), noise=p_noise, generator=generator)

    if before_data is not None and variant != "plain":
      if tuple(before_data.shape) != tuple(shape):
        raise ValueError(f"before_data of shape {tuple(before_data.shape)} "
                         f"for a sampler of shape {tuple(shape)}")
      x = x_mean = before_data.to(device=device, dtype=torch.float32)
    else:
      x = sde.prior_sampling(shape, generator, device, prior_noise,
                             data_mean=data_mean)
      x_mean = x
    x_search = None
    if variant == "plain":
      x_search = x
      for i in range(num_scales):
        x, x_mean = step(x, ts[i], None, snr_at(i))
        if i == num_scales - 2:  # kept for the VE denoise search
          x_search = x_mean
    elif before_data is None and variant == "search":
      for i in range(sde.N - 1):
        x, x_mean = step(x, ts[i], ts[i + 1], config.sampling.snr)
    elif before_data is None:
      for i in range(sde.N):
        x, x_mean = step(x, ts[i], ts[min(i + 1, sde.N - 1)], None)
    if variant == "search" and not config.sampling.need_sample:
      den = reverse_diffusion_predictor(sde, score_fn, probability_flow=True)
      start = x_mean if denoise else x
      vec_eps = torch.full((b,), eps, device=device)
      # the predictor's mean: its noise does not enter the result
      x = x_mean = den(start, vec_eps, torch.full((b,), float(final_time),
                                                  device=device),
                       noise=torch.zeros_like(start))[1]
    if variant == "more_step" and not config.sampling.need_sample:
      ext = torch.from_numpy(extra).to(device)
      for i in range(len(extra)):
        x, x_mean = step(x, ext[i], None, config.sampling.snr)
    before = x_mean if denoise else x
    after = (flow_inverse(before * temperature) if flow_inverse is not None
             else before)
    to_nhwc = lambda v: inverse_scaler(v).permute(0, 2, 3, 1)
    return (to_nhwc(before), to_nhwc(after),
            None if x_search is None else to_nhwc(x_search),
            sde.N * (n_steps + 1))

  return pc_sampler


def get_ode_sampler(config, sde, shape, inverse_scaler, denoise=False,
                    rtol=1e-5, atol=1e-5, eps=1e-3, device="cuda"):
  """`shape` is NCHW. The ODE's number of function evaluations is counted
  as the JAX sampler counts it (the denoise step adds one score
  evaluation). `before_data` and `final_time` are taken and not read, as
  in the JAX package."""

  def ode_sampler(score_fn, flow_inverse=None, temperature=1.0,
                  generator: Optional[torch.Generator] = None,
                  prior_noise: Optional[torch.Tensor] = None,
                  data_mean: Optional[torch.Tensor] = None,
                  before_data=None, final_time: float = 0.0):
    x = sde.prior_sampling(shape, generator, device, prior_noise,
                           data_mean=data_mean)
    rsde = sde.reverse(score_fn, probability_flow=True)

    def ode_fn(t, y):
      vec_t = torch.full((shape[0],), float(t), device=y.device)
      return rsde.sde(y.reshape(shape), vec_t)[0].reshape(-1)

    y, nfe = ode_lib.solve_rk45(ode_fn, sde.T, eps, x.reshape(-1), rtol=rtol,
                                atol=atol)
    x = y.reshape(shape)
    if denoise:
      pred = reverse_diffusion_predictor(sde, score_fn,
                                         probability_flow=False)
      vec_eps = torch.full((shape[0],), eps, device=x.device)
      # the predictor's mean: its noise does not enter the result
      _, x = pred(x, vec_eps, torch.zeros_like(vec_eps),
                  noise=torch.zeros_like(x))
    before = x
    after = (flow_inverse(before * temperature) if flow_inverse is not None
             else before)
    to_nhwc = lambda v: inverse_scaler(v).permute(0, 2, 3, 1)
    return to_nhwc(before), to_nhwc(after), None, nfe

  return ode_sampler


def get_sampling_fn(config, sde, shape, inverse_scaler, eps, device="cuda"):
  name = config.sampling.method.lower()
  if name == "ode":
    return get_ode_sampler(config, sde, shape, inverse_scaler,
                           denoise=config.sampling.noise_removal,
                           rtol=config.eval.rtol, atol=config.eval.atol,
                           eps=eps, device=device)
  if name == "pc":
    return get_pc_sampler(
        config, sde, shape,
        get_predictor(config.sampling.predictor),
        get_corrector(config.sampling.corrector),
        inverse_scaler, snr=config.sampling.snr,
        n_steps=config.sampling.n_steps_each,
        probability_flow=config.sampling.probability_flow,
        denoise=config.sampling.noise_removal, eps=eps, device=device)
  raise NotImplementedError(f"sampler {name!r} is not ported yet")
