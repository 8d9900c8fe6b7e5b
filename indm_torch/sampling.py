"""The probability-flow ODE sampler (PyTorch).

Counterpart of `indm_tpu/sampling.py:81-93, 360-416`: integrate the
probability-flow ODE from T to eps with RK45, take the reverse-diffusion
predictor's mean as the denoise step, pull the sample back through the
flow inverse, and apply the inverse scaler. Samplers take callables:

  score_fn(x, t) -> score        (eval mode, over NCHW x)
  flow_inverse(x) -> x'          (or None for flow.model='identity')

PC predictors and correctors are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from indm_torch import ode as ode_lib
from indm_torch.sde import right_bcast


def reverse_diffusion_predictor(sde, score_fn, probability_flow=False):
  """update_fn(x, t, next_t=None, noise=None) -> (x, x_mean); the noise is
  drawn like x when not given."""
  rsde = sde.reverse(score_fn, probability_flow)

  def update_fn(x, t, next_t=None, noise=None):
    f, G = rsde.discretize(x, t, next_t)
    x_mean = x - f
    z = torch.randn_like(x) if noise is None else noise
    return x_mean + right_bcast(G, x) * z, x_mean

  return update_fn


def get_ode_sampler(config, sde, shape, inverse_scaler, denoise=False,
                    rtol=1e-5, atol=1e-5, eps=1e-3, device="cuda"):
  """`shape` is NCHW. The sampler returns the NHWC images before and after
  the flow, and the ODE's number of function evaluations, counted as the
  JAX sampler counts them (the denoise step adds one score evaluation)."""

  def ode_sampler(score_fn, flow_inverse=None, temperature=1.0,
                  generator: Optional[torch.Generator] = None,
                  prior_noise: Optional[torch.Tensor] = None):
    x = sde.prior_sampling(shape, generator, device, prior_noise)
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
    return to_nhwc(before), to_nhwc(after), nfe

  return ode_sampler


def get_sampling_fn(config, sde, shape, inverse_scaler, eps, device="cuda"):
  name = config.sampling.method.lower()
  if name != "ode":
    raise NotImplementedError(f"sampler {name!r} is not ported yet")
  return get_ode_sampler(config, sde, shape, inverse_scaler,
                         denoise=config.sampling.noise_removal,
                         rtol=config.eval.rtol, atol=config.eval.atol,
                         eps=eps, device=device)
