"""One whole ODE sampling round of the port against the JAX sampler.

Both run the tiny geometry of `tests/test_golden.py` (score net with
`init_scale = 1.0`; flow `nblocks="2-2"`). The port runs the slice's
`model.fused_groupnorm=True` (its plain version on the CPU); the JAX side
runs its default GroupNorm, whose agreement with its fused kernel is the
JAX package's own test (`test_ncsnpp_fused_groupnorm_config_parity`), to
keep the JAX compile short. The port's seeded weights go to the JAX models
through the JAX package's converters, and the JAX noise is replayed: the
prior sample (`split(rng, 3)` -> `prior_sampling`) and the prior flow's
epsilon (`split(PRNGKey(0))` -> rng_h -> `sample_from_prior`). The solver
runs at rtol = atol = 1e-3 instead of the config's 1e-5 to keep the round
short; the number of function evaluations must be equal, and the images
agree within 1e-4 of their largest magnitude after the adaptive solver's
float32 steps.
"""

import jax
import numpy as np
import torch

from indm_torch import configs as torch_configs
from indm_torch import run_lib as torch_run_lib
from indm_torch import sample as torch_sample
from indm_torch.ops import group_norm as gn
from indm_tpu import configs as jax_configs
from indm_tpu import data as jax_data
from indm_tpu import sampling as jax_sampling
from indm_tpu import sde as jax_sde
from indm_tpu.flows import convert as jax_flow_convert
from indm_tpu.flows import flow_model as jax_fm
from indm_tpu.models import get_score_fn as jax_get_score_fn
from indm_tpu.models.convert import ncsnpp_params_from_torch
from indm_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp
from torch_threads import one_torch_thread  # noqa: F401

TINY = {"data.image_size": 8, "model.nf": 8, "model.num_res_blocks": 1,
        "model.ch_mult": (1, 1), "model.attn_resolutions": (4,),
        "model.init_scale": 1.0, "model.fused_groupnorm": True,
        "flow.nblocks": "2-2", "flow.intermediate_dim": 8,
        "eval.rtol": 1e-3, "eval.atol": 1e-3}
B = 4


def _set(cfg, name, value):
  *path, leaf = name.split(".")
  node = cfg
  for p in path:
    node = getattr(node, p)
  setattr(node, leaf, value)


def tiny_configs():
  jc = jax_configs.get_config("vp/CIFAR10/indm_nll")
  tc = torch_configs.get_config("vp/CIFAR10/indm_nll")
  for k, v in TINY.items():
    _set(jc, k, v)
    _set(tc, k, v)
  return jc, tc


def test_ode_round_matches_jax_with_replayed_noise():
  jc, tc = tiny_configs()
  s = torch_run_lib.build_sampling(tc, B, device="cpu", seed=5)
  score_sd = s.score_model.state_dict()
  flow_sd = s.flow_model.state_dict()
  params, _ = ncsnpp_params_from_torch(score_sd, jc)
  variables = {"params": params}
  fparams = {
      "resflow": jax_flow_convert.resflow_params_from_torch(flow_sd, jc),
      "disc": {"prior": {
          f"steps_{i}": jax_flow_convert._prior_step(
              flow_sd, f"discriminator.prior.flow.steps.{i}")
          for i in range(2)}}}
  fbuffers = {"batch_stats": {}}

  jc.model.fused_groupnorm = False
  module = JaxNCSNpp(jc)
  fm = jax_fm.create_flow_model(jc)
  j_sde = jax_sde.get_sde(jc)
  shape = (B, 8, 8, 3)
  sampler = jax_sampling.get_sampling_fn(
      jc, j_sde, shape, jax_data.get_data_inverse_scaler(jc),
      jc.sampling.truncation_time)
  score_fn = jax_get_score_fn(jc, j_sde, module, variables, train=False,
                              continuous=True)
  flow_inverse = lambda x: jax_fm.flow_forward(jc, fm, fparams, fbuffers, x,
                                               reverse=True)[0]
  rng = jax.random.PRNGKey(11)
  before_j, after_j, _, nfe_j = jax.jit(
      lambda r: sampler(r, score_fn, flow_inverse))(rng)

  prior_rng = jax.random.split(rng, 3)[1]
  noise = np.array(j_sde.prior_sampling(prior_rng, shape))
  rng_h = jax.random.split(jax.random.PRNGKey(0))[0]
  eps = np.array(fm.disc.apply(
      {"params": fparams["disc"], **fbuffers}, B,
      method=lambda m, n: jax.random.normal(m.make_rng("sample"), (n, m.dim)),
      rngs={"sample": rng_h}))

  gn.reset_launches()
  before_t, after_t, search_t, nfe_t = torch_run_lib.sample_round(
      tc, s, prior_noise=torch.from_numpy(noise.transpose(0, 3, 1, 2)),
      prior_eps=torch.from_numpy(eps))
  assert gn.launches == 0
  assert search_t is None
  assert nfe_t == int(nfe_j)
  assert before_t.shape == after_t.shape == shape
  for ours, theirs in ((before_t, before_j), (after_t, after_j)):
    theirs = np.asarray(theirs)
    span = np.abs(theirs).max()
    np.testing.assert_allclose(ours.numpy() / span, theirs / span, atol=1e-4)


def test_sample_entry_point_writes_rounds(tmp_path, capsys):
  """`python -m indm_torch.sample` on the CPU at the tiny geometry: the
  npz files of each round, uint8 NHWC, and one line of stats per round."""
  args = ["--batch", "2", "--rounds", "2", "--workdir", str(tmp_path),
          "--device", "cpu"]
  for k, v in TINY.items():
    args += ["--set", f"{k}={v}"]
  torch_sample.main(args)
  out = capsys.readouterr().out
  assert out.count("nfe=") == 2 and "images/s=" in out
  for r in range(2):
    for name in (f"samples_{r}.npz", f"samples_{r}_before_flow.npz"):
      with np.load(tmp_path / "eval" / name) as z:
        assert z["samples"].dtype == np.uint8
        assert z["samples"].shape == (2, 8, 8, 3)
