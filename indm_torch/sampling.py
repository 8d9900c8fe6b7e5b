"""The probability-flow ODE sampler and the plain PC sampler (PyTorch).

Counterpart of `indm_tpu/sampling.py:81-172, 210-274, 360-416`. The ODE
sampler integrates the probability-flow ODE from T to eps with RK45 and
takes the reverse-diffusion predictor's mean as the denoise step; the PC
sampler walks a grid of `sampling.num_scales` times from T to eps, a
Langevin corrector then the reverse-diffusion predictor at each. Both
pull the sample back through the flow inverse and apply the inverse
scaler. Samplers take callables:

  score_fn(x, t) -> score        (eval mode, over NCHW x)
  flow_inverse(x) -> x'          (or None for flow.model='identity')

and return (before the flow, after the flow, the PC sampler's step-(N-2)
mean or None, the number of score evaluations), images NHWC, as the JAX
samplers do. Every random draw comes from an explicit `torch.Generator`
or is handed in, so that a test can replay the JAX package's draws.
"""

from __future__ import annotations

from typing import Optional

import torch

from indm_torch import ode as ode_lib
from indm_torch import sde as sde_lib
from indm_torch.sde import right_bcast


def _normal(x, generator):
  return torch.randn(x.shape, generator=generator, device=x.device,
                     dtype=x.dtype)


def reverse_diffusion_predictor(sde, score_fn, probability_flow=False):
  """update_fn(x, t, next_t=None, noise=None, generator=None) ->
  (x, x_mean); the noise is drawn like x from `generator` when not
  given."""
  rsde = sde.reverse(score_fn, probability_flow)

  def update_fn(x, t, next_t=None, noise=None, generator=None):
    f, G = rsde.discretize(x, t, next_t)
    x_mean = x - f
    z = _normal(x, generator) if noise is None else noise
    return x_mean + right_bcast(G, x) * z, x_mean

  return update_fn


def langevin_corrector(sde, score_fn, snr, n_steps):
  """update_fn(x, t, snr_t=None, noise=None, generator=None) ->
  (x, x_mean): `n_steps` Langevin steps whose size makes the noise's norm
  `snr` times the score's (batch means of the per-sample norms). `noise`
  is a list of the n_steps draws; without it they come from
  `generator`. The step's alpha is 1 under the VE SDE; the VP SDE's
  (the DDPM alphas) is not ported."""
  if not isinstance(sde, sde_lib.VESDE):
    raise NotImplementedError("the Langevin corrector is ported for the VE "
                              "SDE only")

  def update_fn(x, t, snr_t=None, noise=None, generator=None):
    target_snr = snr if snr_t is None else snr_t
    alpha = torch.ones_like(t)
    x_mean = x
    for i in range(n_steps):
      grad = score_fn(x, t)
      z = _normal(x, generator) if noise is None else noise[i]
      grad_norm = torch.linalg.vector_norm(
          grad.reshape(grad.shape[0], -1), dim=-1).mean()
      noise_norm = torch.linalg.vector_norm(
          z.reshape(z.shape[0], -1), dim=-1).mean()
      step_size = (target_snr * noise_norm / grad_norm) ** 2 * 2 * alpha
      x_mean = x + right_bcast(step_size, x) * grad
      x = x_mean + right_bcast(torch.sqrt(step_size * 2), x) * z
    return x, x_mean

  return update_fn


PREDICTORS = {"reverse_diffusion": reverse_diffusion_predictor}
CORRECTORS = {"langevin": langevin_corrector}


def _lookup(table, kind, name):
  if name.lower() not in table:
    raise NotImplementedError(f"the {kind} {name!r} is not ported yet; the "
                              f"port runs {sorted(table)}")
  return table[name.lower()]


def get_pc_sampler(config, sde, shape, predictor, corrector, inverse_scaler,
                   snr, n_steps=1, probability_flow=False, denoise=True,
                   eps=1e-3, device="cuda"):
  """The plain PC sampler (`indm_tpu/sampling.py:210-274`) for NCHW
  `shape`, under the VE SDE. The denoise-search (`sampling.pc_denoise`)
  and extra-step (`sampling.more_step`) variants are not ported."""
  if not isinstance(sde, sde_lib.VESDE):
    raise NotImplementedError("the PC sampler is ported for the VE SDE only")
  for switch, what in (("pc_denoise", "the denoise search from the "
                                     "step-(N-2) state"),
                       ("more_step", "the extra corrector and predictor "
                                     "steps")):
    if config.sampling[switch]:
      raise NotImplementedError(f"sampling.{switch}=True ({what}) is not "
                                "ported yet")
  if config.sampling.snr_scheduling != "none":
    raise NotImplementedError("only sampling.snr_scheduling='none' is "
                              "ported")
  num_scales = config.sampling.num_scales
  timesteps = torch.from_numpy(sde_lib.linspace_f32(sde.T, eps, num_scales))

  def pc_sampler(score_fn, flow_inverse=None, temperature=1.0,
                 generator: Optional[torch.Generator] = None,
                 prior_noise: Optional[torch.Tensor] = None,
                 step_noise=None, data_mean: Optional[torch.Tensor] = None):
    """`prior_noise` replaces the prior's standard-normal draw;
    `step_noise(i)` returns step i's (corrector draws, predictor draw) in
    place of draws from `generator`; `data_mean` [C,H,W] centres the prior
    (`eval.data_mean`)."""
    corr = corrector(sde, score_fn, snr, n_steps)
    pred = predictor(sde, score_fn, probability_flow)
    x = sde.prior_sampling(shape, generator, device, prior_noise,
                           data_mean=data_mean)
    ts = timesteps.to(device)
    x_mean = x_search = x
    for i in range(num_scales):
      vec_t = ts[i].expand(shape[0])
      c_noise, p_noise = (None, None) if step_noise is None else step_noise(i)
      x, x_mean = corr(x, vec_t, noise=c_noise, generator=generator)
      x, x_mean = pred(x, vec_t, None, noise=p_noise, generator=generator)
      if i == num_scales - 2:  # kept for the VE denoise search
        x_search = x_mean
    before = x_mean if denoise else x
    after = (flow_inverse(before * temperature) if flow_inverse is not None
             else before)
    to_nhwc = lambda v: inverse_scaler(v).permute(0, 2, 3, 1)
    # the JAX sampler's count, sde.N even where num_scales differs
    return (to_nhwc(before), to_nhwc(after), to_nhwc(x_search),
            sde.N * (n_steps + 1))

  return pc_sampler


def get_ode_sampler(config, sde, shape, inverse_scaler, denoise=False,
                    rtol=1e-5, atol=1e-5, eps=1e-3, device="cuda"):
  """`shape` is NCHW. The ODE's number of function evaluations is counted
  as the JAX sampler counts it (the denoise step adds one score
  evaluation)."""

  def ode_sampler(score_fn, flow_inverse=None, temperature=1.0,
                  generator: Optional[torch.Generator] = None,
                  prior_noise: Optional[torch.Tensor] = None,
                  data_mean: Optional[torch.Tensor] = None):
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
        _lookup(PREDICTORS, "predictor", config.sampling.predictor),
        _lookup(CORRECTORS, "corrector", config.sampling.corrector),
        inverse_scaler, snr=config.sampling.snr,
        n_steps=config.sampling.n_steps_each,
        probability_flow=config.sampling.probability_flow,
        denoise=config.sampling.noise_removal, eps=eps, device=device)
  raise NotImplementedError(f"sampler {name!r} is not ported yet")
